"""`prime32.Plan` of the port vs the JAX package's, on the CPU.

The port's plan runs its tiers' plain twins here (K2's four-step for
n >= 2^14, K3's two passes for 2048 <= n < 2^14, K4's stage engine below or
for p < 2^26, up to 2^17); the JAX plan runs its XLA stage engine. Both must give the
same canonical values bit for bit: fwd, inv, the three elementwise ops and
the polymul, in the lt30, lt31 and generic regimes and for a p < 2^26
prime, against the golden schoolbook oracle and the README vector, and the
plan's tables must equal the JAX package's array for array. Tolerance:
exact equality (modular integers).
"""

import numpy as np
import pytest
import torch

from concrete_ntt_tpu import prime32 as jp32
from concrete_ntt_tpu.golden.polymul import negacyclic_convolution_mod
from concrete_ntt_tpu.ops import mxu32 as jmx
from concrete_ntt_tpu.ops import pallas32 as jpal32
from concrete_ntt_tpu_torch import prime32 as tp32
from concrete_ntt_tpu_torch.golden import polymul as tgold
from concrete_ntt_tpu_torch.ops import mxu32 as tmx
from concrete_ntt_tpu_torch.ops import butterfly32_cuda, mxu32_cuda, ntt_dispatch
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64

PRIMES = {"lt30": 1073479681, "lt31": 2147352577, "generic": 4293918721, "small": 67043329}
SIZES = [2, 32, 256, 1024, 2048, 4096]


def _assert_same(port, ref, path="tables"):
    if isinstance(ref, dict):
        assert port.keys() == ref.keys(), path
        for k in ref:
            _assert_same(port[k], ref[k], f"{path}[{k!r}]")
    elif isinstance(ref, (tuple, list)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray) and port.dtype == ref.dtype, path
        np.testing.assert_array_equal(port, ref, err_msg=path)
    else:
        assert port == ref and type(port) is type(ref), path


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(PRIMES))
def test_plan_matches_jax(rng, name, n):
    p = PRIMES[name]
    tplan, jplan = tp32.Plan.new(n, p, device="cpu"), jp32.Plan.new(n, p)
    assert (tplan.variant, tplan.p_neginv, tplan.n_inv) == (
        jplan.variant, jplan.p_neginv, jplan.n_inv)
    x, y = (rng.integers(0, p, (2, 3, n), dtype=np.uint32) for _ in range(2))
    w = rng.integers(0, 1 << 32, (2, 3, n), dtype=np.uint32)  # any u32 for the elementwise ops
    t = torch.from_numpy
    cases = [
        (tplan.fwd(t(x)), jplan.fwd(x)),
        (tplan.inv(t(x)), jplan.inv(x)),
        (tplan.mul_assign_normalize(t(w), t(y)), jplan.mul_assign_normalize(w, y)),
        (tplan.normalize(t(w)), jplan.normalize(w)),
        (tplan.mul_accumulate(t(w), t(x), t(y)), jplan.mul_accumulate(w, x, y)),
        (tplan.negacyclic_polymul(t(x), t(y)), jplan.negacyclic_polymul(x, y)),
    ]
    for i, (got, want) in enumerate(cases):
        assert got.dtype == torch.uint32 and got.shape == (2, 3, n), i
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"case {i}")


@pytest.mark.parametrize("name", ["lt30", "lt31", "generic"])
def test_plan_at_the_k2_size(rng, name):
    """n = 2^14: the port's K2 twin against the JAX stage engine."""
    p, n = PRIMES[name], 1 << 14
    tplan, jplan = tp32.Plan.new(n, p, device="cpu"), jp32.Plan.new(n, p)
    x = rng.integers(0, p, (2, n), dtype=np.uint32)
    np.testing.assert_array_equal(tplan.fwd(x).numpy(), np.asarray(jplan.fwd(x)))
    np.testing.assert_array_equal(tplan.inv(x).numpy(), np.asarray(jplan.inv(x)))


def test_plan_above_the_kernel_range_runs_the_stage_engine(rng):
    """Kept under its old name: n = 2^16 is inside the four-step range now, so
    the CPU runs K2's plain twin there (as the card runs K2), against the JAX
    plan."""
    p, n = PRIMES["lt30"], 1 << 16
    tplan, jplan = tp32.Plan.new(n, p, device="cpu"), jp32.Plan.new(n, p)
    assert ntt_dispatch.tier32(n, p, tplan.variant) == "K2"
    x = rng.integers(0, p, (1, n), dtype=np.uint32)
    f = tplan.fwd(x)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jplan.fwd(x)))
    np.testing.assert_array_equal(tplan.inv(f).numpy(), np.asarray(jplan.inv(np.asarray(f))))


def test_small_prime_above_2_15_takes_the_stage_tier(rng):
    """Kept under its old name: p < 2^26 at n = 2^16 has no four-step (p too
    small) and takes tier "K4" now (the butterfly kernel over a cluster of
    blocks on the card, its plain twin, the stage engine, on the CPU), where
    the JAX plan runs its XLA stage engine: fwd, inv and the polymul at
    B = 1 equal the JAX plan's bit for bit, and the CPU launches nothing.
    "stage" remains above 2^17."""
    n = 1 << 16
    p = largest_prime_in_arithmetic_progression64(2 * n, 1, 0, 1 << 26)
    tplan, jplan = tp32.Plan.new(n, p, device="cpu"), jp32.Plan.new(n, p)
    assert ntt_dispatch.tier32(n, p, tplan.variant) == "K4"
    assert ntt_dispatch.tier32(4 * n, p, tplan.variant) == "stage"
    x, y = (rng.integers(0, p, (1, n), dtype=np.uint32) for _ in range(2))
    before = (dict(mxu32_cuda.LAUNCHES), dict(butterfly32_cuda.LAUNCHES))
    np.testing.assert_array_equal(tplan.fwd(x).numpy(), np.asarray(jplan.fwd(x)))
    np.testing.assert_array_equal(tplan.inv(x).numpy(), np.asarray(jplan.inv(x)))
    np.testing.assert_array_equal(tplan.negacyclic_polymul(x, y).numpy(),
                                  np.asarray(jplan.negacyclic_polymul(x, y)))
    assert (mxu32_cuda.LAUNCHES, butterfly32_cuda.LAUNCHES) == before


def test_polymul_matches_golden(rng):
    """examples/mul_poly_prime.py: n = 1024, p = 1073479681."""
    n, p = 1024, 1073479681
    lhs = rng.integers(0, p, n).astype(np.uint32)
    rhs = rng.integers(0, p, n).astype(np.uint32)
    got = tp32.Plan.new(n, p, device="cpu").negacyclic_polymul(lhs, rhs)
    want = negacyclic_convolution_mod(lhs.tolist(), rhs.tolist(), p)
    assert got.tolist() == want
    assert tgold.negacyclic_convolution_mod(lhs[:64], rhs[:64], p) == \
        negacyclic_convolution_mod(lhs[:64].tolist(), rhs[:64].tolist(), p)


def test_readme_vector():
    plan = tp32.Plan.new(32, 1062862849, device="cpu")
    x = np.arange(32, dtype=np.uint32)
    got = plan.inv(plan.fwd(x[None]))
    assert got.shape == (1, 32)
    np.testing.assert_array_equal(
        got.numpy()[0], (x.astype(np.uint64) * 32 % plan.p).astype(np.uint32))
    np.testing.assert_array_equal(
        plan.fwd(x).numpy(), np.asarray(jp32.Plan.new(32, 1062862849).fwd(x)))


@pytest.mark.parametrize("n", [256, 2048, 1 << 14])
@pytest.mark.parametrize("name", list(PRIMES))
def test_plan_tables_match_jax(n, name):
    p = PRIMES[name]
    _assert_same(tp32._tables(n, p), jp32._tables(n, p))
    if p >= tmx._MIN_P and n >= 2048:  # the four-step tables, five planes for 4293918721
        port, ref = tmx._mxu_tables(n, p), jmx._mxu_tables(n, p)
        _assert_same(port, ref)
        assert port["A"][1].shape[0] == (5 if name == "generic" else 4)


@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("name", ["lt30", "generic"])
def test_compact_twiddles_index_like_the_expanded_tables(name, direction):
    """Source check of K4's indexing: the JAX kernel's stage-expanded table
    row s, lane j is twid[m + j // (2t)] of the plan's compact table."""
    p, n = PRIMES[name], 256
    tbl = tp32._tables(n, p)
    key = "twid" if direction == "fwd" else "inv_twid"
    expanded = jpal32._expanded_twiddles(n, p, direction)
    for s in range(n.bit_length() - 1):
        m, two_t = 1 << s, n >> s
        idx = m + np.arange(n) // two_t
        np.testing.assert_array_equal(expanded[0][s], tbl[key][idx])
        if name != "generic":
            np.testing.assert_array_equal(expanded[1][s], tbl[key + "_shoup"][idx])


def test_plan_validation_and_inputs(rng):
    assert tp32.Plan.try_new(1024, 1073479681) is not None
    assert tp32.Plan.try_new(3, 17) is None and tp32.Plan.try_new(1 << 20, 17) is None
    plan = tp32.Plan.new(64, PRIMES["lt31"], device="cpu")
    with pytest.raises(TypeError):
        plan.fwd(np.zeros(64, dtype=np.uint64))
    with pytest.raises(ValueError, match="n=64"):
        plan.fwd(np.zeros(32, dtype=np.uint32))
    x = rng.integers(0, plan.p, (4, 2, 64), dtype=np.uint32)
    got = plan.fwd(x)
    assert isinstance(got, torch.Tensor) and got.shape == (4, 2, 64)
    np.testing.assert_array_equal(
        got.numpy().reshape(8, 64), plan.fwd(torch.from_numpy(x.reshape(8, 64))).numpy())


def test_single_range_and_scalar_record():
    for p in (PRIMES["lt30"], PRIMES["lt31"], PRIMES["generic"]):
        mxu32_cuda.check_single_range(2048, p)
        tbl = tmx._mxu_tables(2048, p)
        rec = mxu32_cuda.scalar_record(p)
        chain = tuple(int(v) for v in rec[7:7 + int(rec[6])])
        assert chain == tbl["chain"] and rec[0] == p
        assert (rec[1], rec[2]) == (tbl["c32"], tbl["c32_shoup"])
        assert (rec[3], rec[4]) == (tbl["p_neginv"], tbl["c64_mont"])
        want = 2 if tbl["mont_regime"] else 0 if tbl["lazy4"] else 1
        assert mxu32_cuda.regime(p) == want
    assert len(tmx._reduce_chain(tmx._MIN_P + 1)) == 6  # the longest chain K2/K3 meet
    mxu32_cuda.check_single_range(1 << 16, PRIMES["lt30"])
    mxu32_cuda.check_single_range(1 << 17, PRIMES["generic"], 4)
    for n, p in ((1024, PRIMES["lt30"]), (1 << 18, PRIMES["lt30"]), (4096, PRIMES["small"]),
                 (4096, 2)):
        with pytest.raises(NotImplementedError, match="four-step kernels"):
            mxu32_cuda.check_single_range(n, p)
