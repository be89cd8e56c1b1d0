"""The readers of the port's spans and launch counter (`ntt_bench/spans.py`,
`metrics/{marshal,transform,pointwise,lift}_device_ms.py`,
`metrics/kernel_launches_per_call.py`): on a CPU profile the port's roots
are counted and nothing is read; on a synthetic profile and span buffer each
reader gives its per-call value, leaves the first profiled call out, counts
a stage nested in another once, and reads nothing from a port without
spans."""

from __future__ import annotations

import pytest

from concrete_ntt_tpu_torch.utils import profiling
from ntt_bench import harness, spec
from ntt_bench import spans as spans_mod
from ntt_bench.tests.test_bench_harness import NATIVE, PBS, SEED, small
from ntt_bench.trace import Profile, profile_calls

STAGE_READERS = {f"{s}_device_ms": s for s in ("marshal", "transform", "pointwise", "lift")}
READERS = [*STAGE_READERS, "kernel_launches_per_call"]
ROOT_NAME = "ntt.native64.negacyclic_polymul"


def read(name: str, win):
    return spec.load_module("metrics", name).read(win)


@pytest.mark.parametrize("workload,roots", [(NATIVE, 1), (PBS, 6)])
def test_a_cpu_profile_holds_the_roots_and_reads_nothing(workload, roots):
    """On the CPU the port's roots are on the host timeline (one polymul; a
    step's fwd, four mul_accumulate and inv) but no device operation is, so
    every reader returns None, as the traced run's host-only line shows."""
    cell = small(workload)
    entry = spec.load_module("entries", cell.config["entry"])
    work = entry.Workload(cell.config, cell.traffic, SEED, "cpu")
    win = harness.Window(setup_s=0.0, profile=profile_calls(work.call, 2, lambda: None))
    assert win.profile.cpu and not win.profile.device
    assert spans_mod._outermost_calls(win.profile.cpu) == 2 * roots
    assert all(read(name, win) is None for name in READERS)


class Buffer:
    """Span records of consecutive calls, each: a root with `launches`;
    marshal, transform (a channel plan's root with its own transform span
    nested inside), pointwise, lift, marshal; device ms `scale` times the
    base values."""

    BASE = {"marshal": 1.0, "transform": 2.0, "pointwise": 4.0, "lift": 8.0}

    def __init__(self):
        self.records, self.cpu, self.t = [], [], 0

    def _rec(self, name, stage, parent, root, device_ms, launches=None):
        index = len(self.records)
        self.records.append({"index": index, "name": name, "stage": stage, "parent": parent,
                             "root": index if root is None else root, "nbytes": 64,
                             "launches": launches, "device_ms": device_ms})
        return index

    def call(self, scale: float, launches: int, host: bool = True):
        r = self._rec(ROOT_NAME, None, None, None, 20.0 * scale, launches)
        start = self.t
        for stage in ("marshal", "transform", "pointwise", "lift", "marshal"):
            i = self._rec(f"ntt.{stage}", stage, r, r, self.BASE[stage] * scale)
            if stage == "transform":
                c = self._rec("ntt.prime32.fwd", None, i, r, 1.5 * scale)
                self._rec("ntt.transform", "transform", c, r, 1.5 * scale)
            if host:
                self.cpu.append((self.t + 1, self.t + 2, f"ntt.{stage}"))
                self.cpu.append((self.t + 1, self.t + 2, "aten::add"))
            self.t += 3
        if host:
            self.cpu.append((start, self.t, ROOT_NAME))
        self.t += 1

    def window(self, calls: int):
        prof = Profile(calls=calls, span=(0, self.t), cpu=sorted(self.cpu),
                       device=[(0, 1, "kernel")])
        return harness.Window(setup_s=0.0, profile=prof)


@pytest.fixture
def buffer(monkeypatch):
    buf = Buffer()
    monkeypatch.setattr(profiling, "recorded_spans", lambda: [dict(r) for r in buf.records])
    return buf


def _two_counted(buf):
    buf.call(scale=100.0, launches=30, host=False)  # the first profiled call: left out
    buf.call(scale=1.0, launches=3)
    buf.call(scale=1.0, launches=3)
    return buf.window(calls=2)


@pytest.mark.parametrize("name,want", [("marshal_device_ms", 2.0), ("transform_device_ms", 2.0),
                                       ("pointwise_device_ms", 4.0), ("lift_device_ms", 8.0),
                                       ("kernel_launches_per_call", 3.0)])
def test_each_reader_gives_its_per_call_value(buffer, name, want):
    assert read(name, _two_counted(buffer)) == want


def test_the_nested_transform_counts_once_in_the_outer_span(buffer):
    win = _two_counted(buffer)
    _, spans = spans_mod.counted(win)
    nested = [s for s in spans if s["stage"] == "transform"]
    assert len(nested) == 4  # two a call, one inside the other
    assert spans_mod.stage_ms(win, "transform") == 2.0


@pytest.mark.parametrize("name", READERS)
def test_nothing_is_read_without_spans(buffer, monkeypatch, name):
    win = _two_counted(buffer)
    assert read(name, harness.Window(setup_s=0.0)) is None  # no profile
    device, win.profile.device = win.profile.device, []
    assert read(name, win) is None  # no device operation
    win.profile.device = device
    records = list(buffer.records)
    buffer.records.clear()
    assert read(name, win) is None  # host events but an empty buffer
    buffer.records[:] = records
    monkeypatch.delattr(profiling, "recorded_spans")  # a port without spans
    assert read(name, win) is None


@pytest.mark.parametrize("name", READERS)
def test_a_missing_device_time_or_count_reads_nothing(buffer, name):
    win = _two_counted(buffer)
    for r in buffer.records:
        r["device_ms"] = None
        r["launches"] = None
    assert read(name, win) is None


def test_the_host_events_decide_how_many_roots_count(buffer):
    """Only the outermost ntt. host events count: the stage events inside
    a root and the host's own operations do not."""
    win = _two_counted(buffer)
    assert spans_mod._outermost_calls(win.profile.cpu) == 2
    roots, spans = spans_mod.counted(win)
    assert [r["launches"] for r in roots] == [3, 3]
    assert len(spans) == 2 * 8
