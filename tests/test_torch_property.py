"""Property-based parity of the port's plain path (hypothesis), the twin of
tests/test_property.py: adversarial coefficients (0, 1, p - 1, p / 2) and
the algebraic laws every plan must satisfy, on the port's `prime32.Plan` and
`native64.Plan32` at N = 64 (64 ... 1024 for the round trip) with
device="cpu", against the JAX package's pure-Python golden oracle
(`concrete_ntt_tpu.golden`, the reference), with the port's own golden
(`concrete_ntt_tpu_torch.golden`) held to it on the same inputs.
Tolerance: exact equality.
"""

import numpy as np
from hypothesis import given, settings, strategies as st

from concrete_ntt_tpu.golden import ntt as ref_ntt
from concrete_ntt_tpu.golden.polymul import negacyclic_convolution_wrapping as ref_wrapping
from concrete_ntt_tpu_torch import native64, prime32
from concrete_ntt_tpu_torch.golden import ntt as gntt
from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_wrapping
from concrete_ntt_tpu_torch.tables import PRIMES32

P = PRIMES32[0]
N = 64

coeff = st.one_of(
    st.integers(0, P - 1),
    st.sampled_from([0, 1, P - 1, P // 2, P // 2 + 1]),
)


def _plan32():
    return prime32.Plan.new(N, P, device="cpu")


@settings(max_examples=25, deadline=None)
@given(st.lists(coeff, min_size=N, max_size=N))
def test_fwd_matches_golden_on_adversarial_inputs(xs):
    x = np.array(xs, dtype=np.uint32)[None]
    want = ref_ntt.fwd(xs, P, N)
    assert _plan32().fwd(x)[0].tolist() == want
    assert gntt.fwd(xs, P, N) == want
    want_inv = ref_ntt.inv(want, P, N)
    assert _plan32().inv(_plan32().fwd(x))[0].tolist() == want_inv
    assert gntt.inv(want, P, N) == want_inv


@settings(max_examples=15, deadline=None)
@given(
    st.lists(st.integers(0, P - 1), min_size=N, max_size=N),
    st.lists(st.integers(0, P - 1), min_size=N, max_size=N),
    st.integers(0, P - 1),
)
def test_transform_linearity(xs, ys, c):
    """fwd(c·x + y) == c·fwd(x) + fwd(y) (mod p): the NTT is linear."""
    plan = _plan32()
    x, y = np.array(xs, dtype=np.uint64), np.array(ys, dtype=np.uint64)
    combo = np.array([(c * a + b) % P for a, b in zip(xs, ys)], dtype=np.uint32)[None]
    fx = plan.fwd(x.astype(np.uint32)[None])[0].tolist()
    fy = plan.fwd(y.astype(np.uint32)[None])[0].tolist()
    assert plan.fwd(combo)[0].tolist() == [(c * a + b) % P for a, b in zip(fx, fy)]


@settings(max_examples=10, deadline=None)
@given(
    st.integers(0, (1 << 64) - 1),
    st.integers(0, N - 1),
    st.booleans(),
)
def test_native64_monomial_product_wraps_exactly(v, shift, negate):
    """lhs · (±x^s) is an exact rotation with sign wrap in Z/2^64[x]/(x^N+1),
    and equals the reference's golden wrapping product (and the port's)."""
    plan = native64.Plan32.try_new(N, device="cpu")
    lhs = np.full((1, N), v, dtype=np.uint64)
    lhs[0, ::3] = np.uint64(v ^ 0xDEADBEEF)
    rhs = np.zeros((1, N), dtype=np.uint64)
    rhs[0, shift] = np.uint64((1 << 64) - 1) if negate else np.uint64(1)
    got = np.asarray(plan.negacyclic_polymul(lhs, rhs))[0]
    rolled = np.zeros(N, dtype=np.uint64)
    rolled[shift:] = lhs[0, : N - shift]
    rolled[:shift] = (-lhs[0, N - shift:].astype(np.int64)).astype(np.uint64)
    want = (-rolled.astype(np.int64)).astype(np.uint64) if negate else rolled
    np.testing.assert_array_equal(got, want)
    want = ref_wrapping(lhs[0].tolist(), rhs[0].tolist(), 64)
    assert got.tolist() == want
    assert negacyclic_convolution_wrapping(lhs[0].tolist(), rhs[0].tolist(), 64) == want


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 5))
def test_roundtrip_random_sizes(log_extra):
    n = 32 << log_extra  # 64..1024
    plan = prime32.Plan.try_new(n, P, device="cpu")
    assert plan is not None
    rng = np.random.default_rng(log_extra)
    x = rng.integers(0, P, (2, n), dtype=np.uint32)
    y = plan.inv(plan.fwd(x)).numpy()
    np.testing.assert_array_equal(
        y, (x.astype(np.uint64) * np.uint64(n) % np.uint64(P)).astype(np.uint32))
