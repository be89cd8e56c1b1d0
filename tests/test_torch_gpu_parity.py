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
import types

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


# row-name prefixes of the checks that only a parity phase of chip_smoke.py
# made before the gate held them, with the n each is at
GATE_ONLY = {"K2h forced tiles": (1 << 16,), "K1e forced tiles": (1 << 14,),
             "K1c / K1d tile instances": (1 << 14,), "K3 pass_matmod_multi tile codes": (1 << 14,),
             "K6 pass_matmod64_multi tile codes": (1 << 14,), "K5/K6 instance": gp.INST64_N,
             "K3 pass_matmod n=": gp.N_FOURSTEP, "K6 pass_matmod64 n=": gp.N_FOURSTEP[:5],
             "K1c-hyb fwd_multi_perchannel": gp.N_FOURSTEP[4:],
             "hybrid32 channel grids vs direct": gp.N_FOURSTEP[4:],
             "engine64_fused": (1 << 15,), "K7 hybrids vs direct": (1 << 15,),
             "W4-64 fwd64_u128 n=16384 B=3 p50": (1 << 14,),
             "plan product pbs loop": (1 << 11, 1 << 14),
             # K1a / K1b and the lifts at the native64 and native128 cells' shapes
             "K1a fwd_wide_multi n=16384 B=8 C=5 limbs=2": (1 << 14,),
             "K1b inv_multi n=16384 B=8 C=5 scaled": (1 << 14,),
             "lift rec_u64_from5 n=16384 B=8": (1 << 14,),
             "K1a fwd_wide_multi n=65536 B=8 C=10 limbs=4": (1 << 16,),
             "lift rec_u128_from10 n=65536 B=8": (1 << 16,)}


@pytest.mark.parametrize("prefix", sorted(GATE_ONLY))
def test_gate_holds_the_checks_chip_smoke_dropped(prefix):
    """Each kind of check is in rows() at each of its n, and in
    rows(quick=True) exactly where its n is in QUICK_N."""
    full, quick = ({r.n for r in rows if r.name.startswith(prefix)}
                   for rows in (gp.rows(), gp.rows(quick=True)))
    assert full == set(GATE_ONLY[prefix])
    assert quick == full & set(gp.QUICK_N)


def test_ragged_shapes_and_k4_clusters_are_reached():
    """The tensor-core pass at the ragged batches BATCHES does not give, and
    K4 on every cluster size it takes (1, 2, 4, 8 blocks a polynomial)."""
    from concrete_ntt_tpu_torch.ops import butterfly32_cuda

    names = [r.name for r in gp.rows()]
    for n, b in gp.RAGGED.items():
        assert sum(s.endswith("(ragged)") and f" n={n} B={b} " in s for s in names) == 6
    clusters = {butterfly32_cuda.cluster_size(r.n, int(r.name.split(" B=")[1].split()[0]))
                for r in gp.rows() if r.name.startswith("K4 ")}
    assert clusters == {1, 2, 4, 8}


def test_pointwise_rows_reach_every_channel_count_the_scalar_instance_and_the_cells():
    """The pointwise product's rows: C = 5 and 10 at every n, every C from 1
    to 10 at 2^11, the scalar instance (a misaligned base, a count of 6),
    and the two cells' shapes; under --quick where their n is in QUICK_N."""
    rows = [r for r in gp.rows() if r.name.startswith("pointwise mont_mul32 ")]
    assert {r.n for r in rows} == set(gp.N_SMALL + gp.N_FOURSTEP)
    names = {r.name for r in rows}
    for n in gp.N_SMALL + gp.N_FOURSTEP:
        for c in (5, 10):
            assert any(f" n={n} " in s and s.endswith(f" C={c}") for s in names), (n, c)
    assert {int(s.split(" C=")[1].split()[0]) for s in names if " n=2048 " in s} == set(
        range(1, 11))
    assert "pointwise mont_mul32 n=16384 B=256 C=5" in names
    assert "pointwise mont_mul32 n=65536 B=64 C=10" in names
    assert {r.name for r in rows if r.tiles == "scalar"} == {
        "pointwise mont_mul32 n=2048 B=3 C=5 offset=1", "pointwise mont_mul32 n=2 B=3 C=5"}
    quick = {r.n for r in gp.rows(quick=True) if r.name.startswith("pointwise mont_mul32 ")}
    assert quick == set(gp.QUICK_N)


def test_tile_rows_ask_for_every_instance_their_rules_pick():
    """The rows that require tile instances launched: K1c / K1d's shapes take
    all eight (epilogue, code) instances of their passes by `k1_tile`; K3's
    and K6's grid shapes every code of `k3_multi_tile` / `k6_tile`; the
    forced rows every code pair."""
    from concrete_ntt_tpu_torch.ops import mxu32

    rows = {r.name: r for r in gp.rows(quick=True)}
    (k1cd,) = (r for name, r in rows.items() if name.startswith("K1c / K1d tile instances"))
    instances = set()
    for name, t1, t2 in k1cd.ran:
        first = "scaled+pointwise" if name.startswith("pointwise") else "scaled"
        instances |= {(first, t1), ("canonical", t2)}
    assert instances >= {("scaled", 1), ("scaled", 2), ("canonical", 1), ("canonical", 2),
                         ("canonical", 3), ("scaled+pointwise", 1), ("scaled+pointwise", 2),
                         ("scaled+pointwise", 3)}
    n1, n2 = mxu32.four_step_factors(1 << 14)
    codes = set()
    for b, s, c in gp.K3_TILE_SHAPES:
        codes |= {mxu32_tile(b, r, o, c, k, sc)
                  for r, o, k, sc in ((n2 // s, n1, n1, True), (n1 // s, n2, n2, False),
                                      (n1 // s, n2, n2, True), (n2 // s, n1, n1, False))}
    assert codes == {0, 1, 2, 3}
    assert {k for r in rows.values() if r.name.startswith("K3 pass_matmod_multi tile codes")
            for k in r.ran} == {("pass_matmod_multi", t) for t in range(4)}
    from concrete_ntt_tpu_torch.ops import mxu64_cuda

    assert {mxu64_cuda.k6_tile(b * r, o, c) for b, s, c in gp.K6_TILE_SHAPES
            for r, o in ((n2 // s, n1), (n1 // s, n2))} == {0, 1}
    forced = [r for r in rows.values() if "forced tiles" in r.name]
    assert len(forced) == 10 and all(len(r.ran) >= 12 for r in forced)


def mxu32_tile(b, rows, o, c, k, scaled):
    from concrete_ntt_tpu_torch.ops import mxu32_cuda

    return mxu32_cuda.k3_multi_tile(b, rows, o, c, k // 32, scaled, 4)


def test_instance_primes_are_their_instances():
    """Each prime of `instances64` takes its (digit planes, epilogue regime)
    instance of the 64-bit pass."""
    from concrete_ntt_tpu_torch.ops import mxu64, mxu64_cuda

    regimes = ("shoup", "montshoup", "montmont", "gl")
    for (n_d, regime), p in gp.instances64().items():
        assert (mxu64._n_dplanes(p), regimes[mxu64_cuda.mode(p)]) == (n_d, regime), p
        assert (p - 1) % (1 << 15) == 0


def test_plan_rows_carry_their_routes_launches():
    """Every plan, route and fixture row says what its call launches on the
    card: the route's kernels (the counters' keys of
    `utils/profiling.launch_counts`)."""
    from concrete_ntt_tpu_torch.utils import profiling

    rows = {r.name: r for r in gp.rows() if r.kind != "kernel"}
    keys = set(profiling.launch_counts())
    for r in rows.values():
        assert r.launches is not None and set(r.launches) <= keys, r.name
    want = {
        "plan native64.Plan32 polymul n=16384 B=8 route K1":
            {"fwd_wide_multi": 2, "pointwise_mont32": 1, "inv_multi": 1, "lift_u64_from5": 1},
        "plan native128.Plan32 polymul n=65536 B=8 route K1":
            {"fwd_wide_multi_u128": 2, "pointwise_mont32": 1, "inv_multi": 1,
             "lift_u128_digits": 1, "lift_u128_limbs": 1},
        "plan native_binary128.Plan32 polymul n=16384 B=8 route K1":
            {"fwd_wide_multi_u128": 1, "fwd_wide_multi": 1, "pointwise_mont32": 1,
             "inv_multi": 1},
        "plan native64.Plan52 round trip n=16384 B=3": {"fwd_multi64": 1, "inv64": 3},
        "plan native32.Plan32 polymul n=1024 B=8 route None":
            {"butterfly32_fwd": 6, "butterfly32_inv": 3},
        "plan native64.Plan32 polymul n=512 B=8 route None":
            {"butterfly32_fwd": 10, "butterfly32_inv": 5, "lift_u64_from5": 1},
        "plan prime32 polymul n=16384 B=1 lt30 tier K2": {"fwd": 2, "inv": 1},
        "plan prime32 polymul n=65536 B=3 small tier K4":
            {"butterfly32_fwd": 2, "butterfly32_inv": 1},
        "plan prime64 polymul n=2048 B=1 gl tier K5": {"fwd64": 2, "inv64": 1},
        "plan prime64 polymul n=65536 B=1 gl tier K5h": {"fwd64_hyb": 2, "inv64_hyb": 1},
        "plan prime64 polymul n=1024 B=1 gl tier stage": {},
        "plan product replace polymul n=16384 B=16 small+lt30 route None":
            {"butterfly32_fwd": 2, "butterfly32_inv": 1, "fwd": 2, "inv": 1},
        "plan prime32 polymul n=262144 B=1 stage32 tier stage": {},
        "plan product bounded polymul n=16384 B=16 2x30 route K1":
            {"fwd_multi_perchannel": 1, "fwd_wide_multi": 1, "pointwise_inv_multi": 1},
        "plan product replace polymul n=16384 B=3 lt31+gen5 route K2": {"fwd": 4, "inv": 2},
        "plan product replace polymul n=16384 B=1 lt30+p34 route K1":
            {"fwd_wide_multi": 2, "inv_multi": 1, "fwd64": 2, "inv64": 1},
        "plan product pbs loop n=16384 B=16 2x30 terms=16":
            {"fwd_multi_perchannel": 16, "fwd_wide_multi": 16, "inv_multi": 1},
    }
    for name, launches in want.items():
        assert rows[name].launches == launches, name


def test_the_plan52_cell_row_launches_both_routes():
    """native64 Plan52 at the shape of the cell native64-plan52-n16384-b256,
    in full and under --quick: K7a x2 and K7d, and native64 Plan32's five
    launches for the comparison of every row."""
    for quick in (False, True):
        (row,) = [r for r in gp.rows(quick) if r.name.endswith("(the cell's shape)")]
        assert row.name == "plan native64.Plan52 polymul n=16384 B=256 route K7 (the cell's shape)"
        assert row.launches == {"fwd_multi64": 2, "pointwise_inv_multi64": 1,
                                "fwd_wide_multi": 2, "pointwise_mont32": 1, "inv_multi": 1,
                                "lift_u64_from5": 1}
        assert [v for _, _, v in row.routes] == ["K7", "K5", "K5", "K5", "K1"]


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_the_plan52_cell_row_catches_a_wrong_word(quick, monkeypatch):
    """The row's check at a small shape on the CPU: a sound run passes; one
    word of one row flipped in Plan52's output fails."""
    from concrete_ntt_tpu_torch import native64

    ctx = gp.Ctx("cpu", quick, gp.SEED)
    assert "all 3 rows == native64.Plan32" in gp.check_row(ctx, gp.plan52_cell_row(2048, 3))
    sound = native64.Plan52.negacyclic_polymul

    def flipped(self, lhs, rhs, rhs_binary=False):
        out = sound(self, lhs, rhs, rhs_binary)
        out[1].view(-1)[2 * 2048 + 7] ^= 1
        return out
    monkeypatch.setattr(native64.Plan52, "negacyclic_polymul", flipped)
    with pytest.raises(gp.Mismatch, match=r"rows \[2\] differ from native64.Plan32"):
        gp.check_row(ctx, gp.plan52_cell_row(2048, 3))


def test_rows_hold_the_dispatcher_to_the_written_routes():
    """Every plan, route and fixture row names the routes it expects, from
    the gate's own table, and the dispatcher returns each of them; the
    benchmark cells' routes are those of the table."""
    rows = [r for r in gp.rows() if r.kind != "kernel"]
    assert all(r.routes for r in rows)
    for r in rows:
        for fn, arg, want in r.routes:
            assert gp.dispatched(fn, r.n, arg) == want, (r.name, fn, arg)
    by_name = {r.name: r for r in rows}
    for name, route in (("plan native64.Plan32 polymul n=16384 B=8 route K1", "K1"),
                        ("plan native128.Plan32 polymul n=65536 B=8 route K1", "K1"),
                        ("plan prime64 polymul n=2048 B=1 gl tier K5", "K5")):
        assert by_name[name].routes[0][2] == route, name


def test_a_row_fails_where_the_dispatcher_leaves_its_route(monkeypatch):
    from concrete_ntt_tpu_torch.ops import ntt_dispatch

    (row,) = [r for r in gp.rows(quick=True)
              if r.name == "plan native64.Plan32 polymul n=16384 B=8 route K1"]
    monkeypatch.setattr(ntt_dispatch, "route32", lambda n, primes: "K2")
    with pytest.raises(gp.Mismatch, match="not the K1 of ROUTES"):
        gp.check_row(gp.Ctx("cpu", True, gp.SEED), row)


def test_quick_plan_rows_compare_every_row_with_the_cpu():
    """Under --quick on the card a plan row also holds its whole output to
    the same plan on the CPU; elsewhere that check is off."""
    got = np.arange(12, dtype=np.uint64).reshape(3, 4)
    card = types.SimpleNamespace(quick=True, dev=torch.device("cuda"))
    assert gp.on_cpu(card, lambda device: got.copy(), got) == "; all 3 rows == the plan on the CPU"
    bad = got.copy()
    bad[2, 1] += 1
    with pytest.raises(gp.Mismatch, match=r"rows \[2\] differ"):
        gp.on_cpu(card, lambda device: bad, got)
    for ctx in (types.SimpleNamespace(quick=False, dev=torch.device("cuda")),
                types.SimpleNamespace(quick=True, dev=torch.device("cpu"))):
        assert gp.on_cpu(ctx, lambda device: bad, got) == ""


def test_max_abs_err_reads_uint32_words_as_unsigned():
    a = torch.tensor([0, 5, 2**32 - 1], dtype=torch.int64).to(torch.uint32)
    b = torch.tensor([0, 7, 0], dtype=torch.int64).to(torch.uint32)
    assert gp.max_abs_err((a, [a]), (a, [a])) == 0
    assert gp.max_abs_err(a, b) == 2**32 - 1
    assert gp.max_abs_err(a, b[:2]) is None


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
