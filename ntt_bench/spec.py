"""What one cell is made of, found by name.

`BENCHMARK.json` at the checkout's root names the cell (`workloads`), its
configuration (`configs`, whose `file` holds the deployment) and its traffic
mix (`ntt_bench/traffic/<traffic>.json`). The configuration names the entry
that drives the port (`ntt_bench/entries/<entry>.py`); each metric the cell
reports has a reader `ntt_bench/metrics/<metric>.py`. A later PR adds a
cell, a configuration, a traffic mix or a metric by adding such files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class Spec:
    workload: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple  # BENCHMARK.json metric entries this cell reports with --trace 0
    per_layer: tuple   # ... and with --trace 1


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(root: str, workload: str, benchmark: dict | None = None) -> Spec:
    """The cell `workload` of `root`/BENCHMARK.json (or of `benchmark`)."""
    bench = benchmark if benchmark is not None else _read(os.path.join(root, "BENCHMARK.json"))
    cell = _named(bench["workloads"], workload, "workload")
    cfg = _named(bench["configs"], cell["config"], "config")
    return Spec(
        workload=workload,
        chips=int(cell["chips"]),
        config=_read(os.path.join(root, cfg["file"])),
        traffic=_read(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json")),
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, workload)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, workload)),
    )


def load_module(kind: str, name: str):
    """ntt_bench/<kind>/<name>.py as a module (an entry or a metric reader)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_spec = importlib.util.spec_from_file_location(f"ntt_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def kernel_names() -> frozenset:
    """The port's own CUDA kernels, as their `__global__` functions are
    named: one file `ntt_bench/kernels/<name>.json` each."""
    folder = os.path.join(BENCH_DIR, "kernels")
    return frozenset(_read(os.path.join(folder, f))["name"] for f in sorted(os.listdir(folder))
                     if f.endswith(".json"))


def peaks(device_kind: str) -> dict | None:
    """The data-sheet peaks of a card by its name, None for another device."""
    return _read(os.path.join(BENCH_DIR, "peaks.json"))["devices"].get(device_kind)
