"""The prime32 butterflies, stage engine and butterfly kernel K4 of the port
(ops/butterflies32.py, ops/engine.py, ops/butterfly32_cuda.py) vs the JAX
package.

Each butterfly is held against the JAX one on edge values of its regime
(0, 1, p - 1, p, 2p - 1, 4p - 1 where it fits in u32, 2^32 - 1); the stage
engine against the JAX engine; K4's plain twin (the route of a CPU tensor)
against the JAX Pallas kernel `pallas32.try_fwd/try_inv` in interpret mode,
the fixture of tests/test_pallas_interpret.py. The kernel itself runs in
tests/test_torch_cuda.py. Tolerance: exact equality (modular integers).
"""

import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu import prime32 as jp32
from concrete_ntt_tpu.ops import butterflies32 as jbf
from concrete_ntt_tpu.ops import engine as jeng
from concrete_ntt_tpu.ops import pallas32 as jpal32
from concrete_ntt_tpu_torch import prime32 as tp32
from concrete_ntt_tpu_torch.ops import butterflies32 as tbf
from concrete_ntt_tpu_torch.ops import butterfly32_cuda as tcu4
from concrete_ntt_tpu_torch.ops import engine as teng
from concrete_ntt_tpu_torch.ops import mxu32_cuda
from concrete_ntt_tpu_torch.ops import ntt_dispatch
from concrete_ntt_tpu_torch.ops.u32 import mont_neginv, to_i64, to_u32

REGIMES = {"lt30": 1073479681, "lt31": 2147352577, "generic": 4293918721}
MAKERS = {
    ("fwd", "lt30"): "make_fwd_lt30",
    ("inv", "lt30"): "make_inv_lt30",
    ("fwd", "lt31"): "make_fwd_lt31",
    ("inv", "lt31"): "make_inv_lt31",
    ("fwd", "generic"): "make_fwd_generic32",
    ("inv", "generic"): "make_inv_generic32",
}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CONCRETE_NTT_TPU_PALLAS_INTERPRET", "1")


def _edges(p: int) -> np.ndarray:
    vals = {0, 1, p - 1, p, 2 * p - 1, 4 * p - 1, (1 << 32) - 1}
    return np.array(sorted(v for v in vals if v < (1 << 32)), dtype=np.uint32)


def _make(module, direction, variant, p):
    fn = getattr(module, MAKERS[(direction, variant)])
    return fn(p, mont_neginv(p)) if variant == "generic" else fn(p)


def _twiddles(rng, p, variant):
    """A few twiddles (edge ones included) and their companion tables."""
    w = np.array([1, 2, p - 1, *rng.integers(0, p, 5)], dtype=np.uint64)
    if variant == "generic":
        return ((w << np.uint64(32)) % np.uint64(p)).astype(np.uint32), None
    return w.astype(np.uint32), ((w << np.uint64(32)) // np.uint64(p)).astype(np.uint32)


@pytest.mark.parametrize("last", [False, True], ids=["stage", "last"])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("variant", list(REGIMES))
def test_butterfly_matches_jax_on_edges(rng, variant, direction, last):
    p = REGIMES[variant]
    e = _edges(p)
    w, ws = _twiddles(rng, p, variant)
    grid = np.array(list(itertools.product(range(len(e)), range(len(e)), range(len(w)))))
    x0, x1, wi = e[grid[:, 0]], e[grid[:, 1]], grid[:, 2]
    wparts = (w[wi],) if ws is None else (w[wi], ws[wi])
    jb = _make(jbf, direction, variant, p)[int(last)]
    tb = _make(tbf, direction, variant, p)[int(last)]
    (jy0,), (jy1,) = jb((jnp.asarray(x0),), (jnp.asarray(x1),), tuple(map(jnp.asarray, wparts)))
    t = lambda a: to_i64(torch.from_numpy(a))
    (ty0,), (ty1,) = tb((t(x0),), (t(x1),), tuple(t(a) for a in wparts))
    np.testing.assert_array_equal(to_u32(ty0).numpy(), np.asarray(jy0))
    np.testing.assert_array_equal(to_u32(ty1).numpy(), np.asarray(jy1))


@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("variant", list(REGIMES))
def test_stage_engine_matches_jax(rng, variant, direction):
    """A sub-range of stages (the sharded seam) and the whole transform."""
    p, n = REGIMES[variant], 64
    tbl = jp32._tables(n, p)
    names = ("twid",) if variant == "generic" else ("twid", "twid_shoup")
    if direction == "inv":
        names = tuple("inv_" + k for k in names)
    x = rng.integers(0, p, (3, n), dtype=np.uint32)
    jb = _make(jbf, direction, variant, p)
    tb = _make(tbf, direction, variant, p)
    jrun = jeng.fwd_stages if direction == "fwd" else jeng.inv_stages
    trun = teng.fwd_stages if direction == "fwd" else teng.inv_stages
    jtw = tuple(jnp.asarray(tbl[k]) for k in names)
    ttw = tuple(to_i64(torch.from_numpy(tbl[k])) for k in names)
    span = {"first_stage": 2, "last_stage": 5} if direction == "fwd" else {
        "first_stage": 5, "last_stage": 2}
    for kw in ({}, span):
        want = jrun((jnp.asarray(x),), jtw, *jb, **kw)[0]
        got = trun((to_i64(torch.from_numpy(x)),), ttw, *tb, **kw)[0]
        np.testing.assert_array_equal(to_u32(got).numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("variant", list(REGIMES))
def test_k4_plain_matches_pallas_interpret(rng, interpret, variant, n):
    p = REGIMES[variant]
    tplan, jplan = tp32.Plan.new(n, p, device="cpu"), jp32.Plan.new(n, p)
    kw = dict(p=p, variant=variant, p_neginv=tplan.p_neginv)
    x = rng.integers(0, p, (9, n), dtype=np.uint32)  # 9: not a multiple of the TPU's 8 rows
    for t_fn, j_fn in ((tcu4.try_fwd, jpal32.try_fwd), (tcu4.try_inv, jpal32.try_inv)):
        want = j_fn(jnp.asarray(x), jplan._tbl, **kw)
        assert want is not None
        got = t_fn(torch.from_numpy(x), tplan._tbl, **kw)
        assert got.dtype == torch.uint32 and got.shape == (9, n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k4_plain_serves_below_the_tpu_floor(rng):
    """n < 256 (the TPU kernel's floor) and p < 2^26: the plain twin is the
    stage engine, equal to the JAX XLA path."""
    p = 67043329
    for n in (2, 8, 128):
        tplan, jplan = tp32.Plan.new(n, p, device="cpu"), jp32.Plan.new(n, p)
        x = rng.integers(0, p, (5, n), dtype=np.uint32)
        kw = dict(p=p, variant="lt30", p_neginv=tplan.p_neginv)
        got = tcu4.try_fwd(torch.from_numpy(x), tplan._tbl, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jplan.fwd(x)))
        got = tcu4.try_inv(torch.from_numpy(x), tplan._tbl, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jplan.inv(x)))


def test_k4_routes_by_device_and_range(rng):
    p, n = REGIMES["lt31"], 256
    plan = tp32.Plan.new(n, p, device="cpu")
    kw = dict(p=p, variant=plan.variant, p_neginv=plan.p_neginv)
    x = torch.from_numpy(rng.integers(0, p, (2, n), dtype=np.uint32))
    with pytest.raises(ValueError, match="no route"):
        tcu4.try_fwd(x.to("meta"), plan._tbl, **kw)
    with pytest.raises(TypeError):
        tcu4.try_fwd(x.to(torch.int64), plan._tbl, **kw)
    with pytest.raises(NotImplementedError, match="stage engine"):  # tier32's route there
        tcu4.check_range(1 << 16, "lt31")
    tcu4.check_range(2, "generic")
    tcu4.check_range(1 << 15, "lt30")
    before = dict(tcu4.LAUNCHES)
    tcu4.try_fwd(x, plan._tbl, **kw)
    assert tcu4.LAUNCHES == before  # the CPU route launches nothing


@pytest.mark.parametrize(
    "n,p,cpu,cuda",
    [
        (1 << 14, REGIMES["lt30"], "K2", "K2"),
        (1 << 15, REGIMES["generic"], "K2", "K2"),
        (4096, REGIMES["lt31"], "K2", "K2"),
        (2048, REGIMES["generic"], "K2", "K2"),
        (1024, REGIMES["lt30"], "K4", "K4"),
        (1 << 14, 67043329, "K4", "K4"),
        (1 << 16, REGIMES["lt30"], "K2", "K2"),
        (1 << 17, REGIMES["generic"], "K2", "K2"),
        (1 << 16, 67043329, "stage", "stage"),
        (1 << 18, REGIMES["lt30"], "stage", "stage"),
    ],
)
def test_tier_choice(n, p, cpu, cuda):
    """K2 for 2^11 <= n <= 2^17 (p >= 2^26; the TPU's two-pass tier below
    2^14 is K2 here), else K4 up to 2^15 and the stage engine above it (the
    reference's XLA route; K4 itself still raises there on the card): the
    CPU and the card take the same tier at every row."""
    variant = tp32._variant(p)
    # the tier is a function of (n, p) alone: no device enters the decision
    assert list(inspect.signature(ntt_dispatch.tier32).parameters) == ["n", "p", "variant"]
    assert ntt_dispatch.tier32(n, p, variant) == cpu == cuda
    if cuda == "K2":
        mxu32_cuda.check_single_range(n, p)
    elif n > tcu4.MAX_N:
        with pytest.raises(NotImplementedError, match="K4"):
            tcu4.check_range(n, variant)
