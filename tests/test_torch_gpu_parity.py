"""tools/gpu_parity.py, the port's hardware parity gate, on the CPU.

Its kernel rows need the card; here: the row list covers every value the
four dispatcher functions (`ntt_dispatch.route32`, `tier32`, `tier64`,
`route64`) return over the sweep's n range and prime sets, in full and at
--quick's sizes; the golden-NTT convolution oracle equals the schoolbook
wrapping oracle; the tool runs a plan row on the plain path with
--device cpu, and refuses to run without a card otherwise; the check
helpers that `chip_smoke.py` takes from the gate (`same_bits`,
`route_passes`), and that the gate loads no `chip_smoke.py`.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_wrapping

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOL = os.path.join(_ROOT, "tools", "gpu_parity.py")
_spec = importlib.util.spec_from_file_location("gpu_parity", _TOOL)
gp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gp)


def _covered(rows) -> set:
    return {(fn, row.n, value) for row in rows for fn, value in row.covers}


def test_rows_cover_every_dispatcher_value():
    walk = gp.walk()
    assert {v for _, _, v in walk} == {"K1", "K2", None, "K4", "stage", "K5", "K5h", "K7", "K7h"}
    missing = walk - _covered(gp.rows())
    assert not missing, sorted(missing, key=str)[:10]


def test_quick_rows_cover_every_dispatcher_value_at_their_sizes():
    walk = {w for w in gp.walk() if w[1] in gp.QUICK_N}
    rows = gp.rows(quick=True)
    assert {row.n for row in rows} <= set(gp.QUICK_N) | {2048}  # 2048: the dense fixture
    assert not walk - _covered(rows)


def test_rows_reach_every_axis_value_at_every_size():
    """B 1 / 3 / 16 at every n of the kernels, and the named shapes of
    PERF.md section 7.5 each have a row."""
    rows = gp.rows()
    names = [r.name for r in rows if r.kind == "kernel"]
    for n in gp.N_FOURSTEP + gp.N_SMALL:
        at_n = [s for s in names if f" n={n} " in s]
        for b in gp.BATCHES:
            assert any(f" B={b} " in s or s.endswith(f" B={b}") for s in at_n), (n, b)
    for n in gp.N_FOURSTEP:
        at_n = [s for s in names if f" n={n} " in s]
        for c in (2, 3, 5, 10):
            assert any(s.startswith("K1") and f" C={c}" in s for s in at_n), (n, c)
        for limbs in (1, 2, 4):
            assert any(s.startswith("K1a") and f"limbs={limbs}" in s for s in at_n), (n, limbs)
    for prefix in ("K1a fwd_wide_multi n=2048 ", "K1b inv_multi n=2048 ", "K1b inv_multi n=131072 ",
                   "K7a fwd_multi64 n=2048 ", "K7d pointwise_inv_multi64 n=32768 ",
                   "K5 fwd64 n=4096 B=1 ", "K4 fwd n=256 B=3 "):
        assert any(s.startswith(prefix) for s in names), prefix
    assert any(s.startswith("K1a fwd_wide_multi n=131072 ") and "limbs=4" in s for s in names)


@pytest.mark.parametrize("width", [32, 64, 128])
def test_golden_ntt_oracle_equals_schoolbook(width):
    rng = np.random.default_rng(width)
    n = 64
    a = [int(v) for v in rng.integers(0, 1 << 63, n, dtype=np.uint64)]
    b = [int(v) for v in rng.integers(0, 1 << 63, n, dtype=np.uint64)]
    if width == 128:
        a = [(v << 65) | v for v in a]
        b = [(v << 65) | v for v in b]
    a = [v % (1 << width) for v in a]
    b = [v % (1 << width) for v in b]
    mask = (1 << width) - 1
    exact = gp.exact_negacyclic(a, b)
    assert [v & mask for v in exact] == negacyclic_convolution_wrapping(a, b, width)
    ks = [0, 1, 31, 63]
    assert gp.sampled_negacyclic(a, b, ks) == [exact[k] for k in ks]


def test_cpu_quick_row_exits_zero():
    res = subprocess.run([sys.executable, _TOOL, "--device", "cpu", "--quick", "--only",
                          r"^plan product bounded polymul n=512 B=16 "], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("# gpu_parity HEAD=") and "kernels sha256=" in lines[0]
    assert [ln.split()[0] for ln in lines[2:-1]] == ["PASS"]
    assert lines[-1].startswith("# 1 PASS, 0 FAIL of 1 checks")


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is what a machine without one does")
    res = subprocess.run([sys.executable, _TOOL, "--quick"], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and "--device cpu" in res.stderr
    assert "PASS" not in res.stdout


def test_same_bits_compares_nested_tensors_bit_for_bit():
    a = torch.tensor([1, 2, 0xFFFFFFFF], dtype=torch.uint32)
    b = a.clone()
    assert gp.same_bits([(a, a), [a]], ((b, b), (b,)))
    b[2] = 0xFFFFFFFE
    assert not gp.same_bits((a,), (b,))
    assert not gp.same_bits((a,), (a, a))
    assert not gp.same_bits((a,), (a[None],))


@pytest.mark.parametrize("pair", [False, True])
def test_route_passes_make_the_sharded_routes_operand_views(pair):
    """A on the value shard [b, n1, n2 / s] read transposed (every limb of
    the operand), F [c, b, n2, n1 / s] and A_inv [c, b, n1, n2 / s] read
    transposed, G [c, b, n1 / s, n2]; the rank's diagonal rows for A and G;
    limb pairs with `pair`, F's and A_inv's hi limbs below 2^18."""
    from concrete_ntt_tpu_torch.ops import mxu32

    n, b, s, c, limbs = 1 << 11, 3, 2, 5, 2
    n1, n2 = mxu32.four_step_factors(n)
    gen = torch.Generator().manual_seed(0)
    u32 = lambda shape, hi=1 << 32: torch.randint(0, hi, shape, generator=gen,
                                                  dtype=torch.int64).to(torch.uint32)
    one = 2 if pair else 1
    got = {w: (x, rows) for w, x, rows in gp.route_passes(u32, n, b, s, c, limbs, pair)}
    assert list(got) == ["A", "F", "G", "Ainv"]
    want = {"A": ((b, n2 // s, n1), one * limbs, (n2 - n2 // s, n2 // s)),
            "F": ((c, b, n1 // s, n2), one, None),
            "G": ((c, b, n1 // s, n2), one, (n1 - n1 // s, n1 // s)),
            "Ainv": ((c, b, n2 // s, n1), one, None)}
    for w, (shape, k, rows) in want.items():
        x, r = got[w]
        assert len(x) == k and all(tuple(t.shape) == shape for t in x), w
        assert r == rows, w
        assert all(t.is_contiguous() == (w == "G") for t in x), w
    for w in ("F", "Ainv"):
        hi = got[w][0][1::2] if pair else ()
        assert all(int(t.to(torch.int64).max()) < 1 << 18 for t in hi), w


def test_gate_loads_no_chip_smoke():
    """chip_smoke.py loads the gate; the gate never loads chip_smoke.py."""
    with open(_TOOL) as f:
        assert "chip_smoke.py" not in f.read()
