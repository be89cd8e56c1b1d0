"""Card tests of the port: each kernel (K1a-K1e, K2, K3 and its channel
grid, K4, K5, K5 with block tables, K6 and its channel grid, K7a-K7d direct
and with block tables; K1a, K2 fwd, K3's A
pass and K5 fwd also with the four limbs of a u128 operand; K1 / K2 / K3 at
n = 2^16 and 2^17; K2 and K1b-K1d with the 32-bit hybrid's block tables)
against its plain torch twin, and the native64 Plan32 and Plan52, prime32, prime64 (direct and
through the stage-split hybrid at 2^16), product and the other native plans'
polymuls (widths 32, 64 and 128, both tiers, the channel routes and the
per-channel route below 2^11) through the kernels against the CPU plain
path; and the sharded paths (`parallel/fourstep_mxu.py`,
`parallel/channels.py`) in a world of two gloo ranks on one card and in one
of a single NCCL rank; the native64 Plan32 polymul captured as a CUDA graph
(`utils/profiling.capture`, the lift kernel of `ops/crt_cuda.py` inside;
its own card tests are in tests/test_torch_crt_cuda.py) against eager, and
`chain_time`'s error on a
step that synchronises with the host.

Every test here is marked `cuda` and skips without a CUDA GPU. The file
imports only the port (no JAX), so it runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest` skips tests/conftest.py, which configures JAX.) Tolerance:
exact equality.
"""

import numpy as np
import pytest
import torch

from concrete_ntt_tpu_torch import (
    native32, native64, native128, native_binary32, native_binary64, native_binary128,
    prime32, prime64, product)
from concrete_ntt_tpu_torch.ops import (
    butterfly32_cuda, mxu32, mxu32_cuda, mxu64, mxu64_cuda, stagesplit)
from concrete_ntt_tpu_torch.tables import GOLDILOCKS, NATIVE128_PRIMES, PRIMES52
from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
from concrete_ntt_tpu_torch.utils import profiling
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as _lp

pytestmark = pytest.mark.cuda

BENCH = {"lt30": 1073479681, "lt31": 2147352577, "generic": 4293918721}
REGIMES64 = {
    "goldilocks": GOLDILOCKS,
    "p50": PRIMES52[0],
    "p63": _lp(1 << 15, 1, 1 << 62, 1 << 63),
    "p64": _lp(1 << 15, 1, 1 << 63, (1 << 64) - 1),
    "p62": _lp(1 << 16, 1, 1 << 61, 1 << 62),
}
# one prime for each of the eight (digit planes, epilogue regime) instances
# of the 64-bit GEMM pass (csrc/mxu64_pass.cu launch_any); 2^16 | p - 1
INSTANCES64 = {
    "shoup-d5": _lp(1 << 16, 1, 1 << 33, 1 << 39),
    "shoup-d6": _lp(1 << 16, 1, 1 << 40, 1 << 47),
    "shoup-d7": PRIMES52[0],
    "shoup-d8": _lp(1 << 16, 1, 1 << 61, 1 << 62),
    "montshoup-d8": _lp(1 << 16, 1, 1 << 62, 1 << 63),
    "montmont-d8": _lp(1 << 16, 1, 1 << 63, 3 << 62),
    "montmont-d9": _lp(1 << 16, 1, 1 << 63, (1 << 64) - 1),
    "gl-d9": GOLDILOCKS,
}
# the same five regimes with 2^18 | p - 1: NTT primes up to n = 2^17
HYB64 = {
    "goldilocks": GOLDILOCKS,
    "p50": _lp(1 << 18, 1, 0, 1 << 50),
    "p62": _lp(1 << 18, 1, 1 << 61, 1 << 62),
    "p63": _lp(1 << 18, 1, 1 << 62, 1 << 63),
    "p64": _lp(1 << 18, 1, 1 << 63, (1 << 64) - 1),
}


@pytest.fixture
def gen():
    return np.random.default_rng(0x5EED)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _u32(gen, shape, device, hi=1 << 32):
    return torch.from_numpy(gen.integers(0, hi, shape, dtype=np.uint32)).to(device)


def _same(got, want):
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("n,b", [(1 << 11, 3), (1 << 14, 5)])
def test_kernels_match_plain_on_card(gen, cuda_device, n, b):
    limbs = (_u32(gen, (b, n), cuda_device), _u32(gen, (b, n), cuda_device))
    for nl in (1, 2):
        got = mxu32_cuda.fwd_wide_multi(limbs[:nl], PRIMES)
        want = mxu32_cuda.fwd_wide_multi_plain(limbs[:nl], PRIMES)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    x = _u32(gen, (len(PRIMES), b, n), cuda_device)
    for scales in ((1,) * len(PRIMES),
                   tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in PRIMES)):
        got = mxu32_cuda.inv_multi(x, PRIMES, scales)
        want = mxu32_cuda.inv_multi_plain(x, PRIMES, scales)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_polymul_on_card_matches_cpu(gen, cuda_device):
    n, b = 1 << 14, 3
    plan = native64.Plan32.try_new(n)  # the default device is the card
    lhs, rhs = ((_u32(gen, (b, n), "cpu"), _u32(gen, (b, n), "cpu")) for _ in range(2))
    profiling.reset_launches()
    got = plan.negacyclic_polymul(tuple(t.to(cuda_device) for t in lhs),
                                  tuple(t.to(cuda_device) for t in rhs))
    assert mxu32_cuda.LAUNCHES == {**dict.fromkeys(mxu32_cuda.LAUNCHES, 0),
                                   "fwd_wide_multi": 2, "inv_multi": 1}
    want = plan.negacyclic_polymul(lhs, rhs)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.parametrize("regime", list(BENCH))
def test_k2_matches_plain_on_card(gen, cuda_device, regime):
    p, n, b = BENCH[regime], 1 << 14, 3
    xs = (_u32(gen, (b, n), cuda_device), _u32(gen, (b, n), cuda_device))
    _same(mxu32_cuda.fwd(xs[0], n=n, p=p), mxu32_cuda.fwd_plain(xs[0], n=n, p=p))
    _same(mxu32_cuda.fwd_wide(xs, n=n, p=p), mxu32_cuda.fwd_wide_plain(xs, n=n, p=p))
    s = pow(n, p - 2, p) * pow(2, 32, p) % p
    _same(mxu32_cuda.inv(xs[0], n=n, p=p, scale=s),
          mxu32_cuda.inv_plain(xs[0], n=n, p=p, scale=s))


@pytest.mark.parametrize("regime", list(BENCH))
def test_k3_matches_plain_on_card(gen, cuda_device, regime):
    p, n, b = BENCH[regime], 4096, 3
    tbl = mxu32._mxu_tables(n, p)
    n1, n2 = tbl["n1"], tbl["n2"]
    d = tuple(torch.from_numpy(a[: n2 // 2]).to(cuda_device) for a in tbl["d"])
    x = _u32(gen, (b, n2 // 2, n1), cuda_device)
    kw = dict(n=n, p=p, which="A", diag_slices=d)
    _same(mxu32_cuda.pass_matmod(x, **kw), mxu32_cuda.pass_matmod_plain(x, **kw))
    y = _u32(gen, (b, n1 // 4, n2), cuda_device)
    kw = dict(n=n, p=p, which="F")
    _same(mxu32_cuda.pass_matmod(y, **kw), mxu32_cuda.pass_matmod_plain(y, **kw))
    z = _u32(gen, (b, n), cuda_device)  # the mid sizes' engine is K2
    _same(mxu32_cuda.passes_engine.fwd(z, n=n, p=p), mxu32_cuda.fwd_plain(z, n=n, p=p))
    _same(mxu32_cuda.passes_engine.inv(z, n=n, p=p), mxu32_cuda.inv_plain(z, n=n, p=p))


@pytest.mark.parametrize("n,p", [(32, BENCH["lt30"]), (1024, BENCH["lt31"]),
                                 (1 << 15, BENCH["generic"]), (1 << 14, 67043329)])
def test_k4_matches_plain_on_card(gen, cuda_device, n, p):
    plan = prime32.Plan.new(n, p)
    kw = dict(p=p, variant=plan.variant, p_neginv=plan.p_neginv)
    x = _u32(gen, (9, n), cuda_device, p)
    _same(butterfly32_cuda.try_fwd(x, plan._tbl, **kw),
          butterfly32_cuda.fwd_plain(x, plan._tbl, **kw))
    _same(butterfly32_cuda.try_inv(x, plan._tbl, **kw),
          butterfly32_cuda.inv_plain(x, plan._tbl, **kw))


@pytest.mark.parametrize("n", [1024, 4096, 1 << 14])
def test_prime32_polymul_on_card_matches_cpu(gen, cuda_device, n):
    p = BENCH["generic"]
    plan = prime32.Plan.new(n, p)
    lhs, rhs = (gen.integers(0, p, (4, n), dtype=np.uint32) for _ in range(2))
    got = plan.negacyclic_polymul(torch.from_numpy(lhs).to(cuda_device),
                                  torch.from_numpy(rhs).to(cuda_device))
    want = prime32.Plan.new(n, p, device="cpu").negacyclic_polymul(lhs, rhs)
    assert want.device.type == "cpu"
    _same(got, want)
    _same(plan.negacyclic_polymul(lhs, rhs), want)  # numpy input goes to the card


@pytest.mark.parametrize("n,b,c,n_h", [
    (1 << 11, 3, 2, None), (1 << 14, 5, 2, None), (1 << 14, 16, 2, None), (1 << 14, 1, 2, None),
    (1 << 16, 8, 2, None), (1 << 16, 8, 3, None), (1 << 16, 5, 3, None), (1 << 15, 8, 3, 1 << 14)])
def test_k1c_k1d_match_plain_on_card(gen, cuda_device, n, b, c, n_h):
    """K1c (1 and 2 limbs) and K1d on the tiles `mxu32_cuda.k1_tile` picks:
    the product plan's (2^14, 16, 2 channels), (2^16, 8) over 2 and 3
    channels, batch edges, and block tables (nb = 2); full-range u32
    operands."""
    from concrete_ntt_tpu_torch.tables import primes32_ext

    primes = (PRIMES if n <= 1 << 15 else primes32_ext())[:c]
    xs = (_u32(gen, (c, b, n), cuda_device), _u32(gen, (c, b, n), cuda_device))
    _same(mxu32_cuda.fwd_multi_perchannel(xs[0], primes, n_h=n_h),
          mxu32_cuda.fwd_multi_perchannel_plain(xs[:1], primes, n_h))
    _same(mxu32_cuda.fwd_wide_multi_perchannel(*xs, primes, n_h=n_h),
          mxu32_cuda.fwd_multi_perchannel_plain(xs, primes, n_h))
    scales = tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in primes)
    _same(mxu32_cuda.pointwise_inv_multi(*xs, primes, scales, n_h=n_h),
          mxu32_cuda.pointwise_inv_multi_plain(*xs, primes, scales, n_h))


@pytest.mark.parametrize("factors", [PRIMES[:2], (2147352577, 4293918721)], ids=["K1", "K2"])
def test_product_polymul_on_card_matches_cpu(gen, cuda_device, factors):
    n, b = 1 << 14, 3
    m = factors[0] * factors[1]
    plan = product.Plan.new(n, m, factors)
    vals = [gen.integers(0, 1 << 64, (b, n), dtype=np.uint64) % np.uint64(m) for _ in range(3)]
    signed = gen.integers(-(1 << 19), 1 << 19, (b, n))
    vals.append(np.where(signed < 0, np.uint64(m) - np.abs(signed).astype(np.uint64),
                         signed.astype(np.uint64)))
    lo_hi = lambda v: torch.from_numpy(np.stack([(v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                                                 (v >> np.uint64(32)).astype(np.uint32)], -1))
    a, c, acc, x = (lo_hi(v) for v in vals)
    for lhs, mode, fm in [(a, product.REPLACE, product.GENERIC),
                          (a, product.ACCUMULATE, product.GENERIC),
                          (x, product.ACCUMULATE, product.bounded(1 << 20))]:
        kw = dict(mode=mode, lhs_fwd_mode=fm)
        got = plan.negacyclic_polymul(lhs.to(cuda_device), c.to(cuda_device),
                                      standard=acc.to(cuda_device), **kw)
        _same(got, plan.negacyclic_polymul(lhs, c, standard=acc, **kw))


def _same_pair(got, want):
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("instance", list(INSTANCES64))
def test_k5_matches_plain_on_card(gen, cuda_device, instance):
    """Each of the eight instances, scaled first pass and canonical second,
    at 2^14 and at 2^11 with a ragged last row tile (96 and 192 rows)."""
    p = INSTANCES64[instance]
    kd, mode = instance.split("-")[1], instance.split("-")[0]
    assert int(kd[1:]) == mxu64._n_dplanes(p)
    assert {"shoup": 0, "montshoup": 1, "montmont": 2, "gl": 3}[mode] == mxu64_cuda.mode(p)
    for n, b in ((1 << 14, 3), (1 << 11, 3)):
        x = (_u32(gen, (b, n), cuda_device), _u32(gen, (b, n), cuda_device))
        _same_pair(mxu64_cuda.fwd(x, n=n, p=p), mxu64_cuda.fwd_plain(x, n=n, p=p))
        for s in (1, pow(n, p - 2, p) * pow(2, 64, p) % p):
            _same_pair(mxu64_cuda.inv(x, n=n, p=p, scale=s),
                       mxu64_cuda.inv_plain(x, n=n, p=p, scale=s))


@pytest.mark.parametrize("instance", list(INSTANCES64))
def test_k6_matches_plain_on_card(gen, cuda_device, instance):
    p, n, b = INSTANCES64[instance], 4096, 3
    tbl = mxu64._tables(n, p)
    n1, n2 = tbl["n1"], tbl["n2"]
    d = tuple(torch.from_numpy(a[: n2 // 2]).to(cuda_device) for a in tbl["d"])
    x = (_u32(gen, (b, n2 // 2, n1), cuda_device), _u32(gen, (b, n2 // 2, n1), cuda_device))
    kw = dict(n=n, p=p, which="A", diag_slices=d)
    _same_pair(mxu64_cuda.pass_matmod64(x, **kw), mxu64_cuda.pass_matmod64_plain(x, **kw))
    y = (_u32(gen, (b, n1 // 4, n2), cuda_device),
         _u32(gen, (b, n1 // 4, n2), cuda_device, 1 << 18))  # mid-pass values, below 2^50
    kw = dict(n=n, p=p, which="F")
    _same_pair(mxu64_cuda.pass_matmod64(y, **kw), mxu64_cuda.pass_matmod64_plain(y, **kw))


@pytest.mark.parametrize("n,b", [(1 << 11, 3), (1 << 14, 5)])
def test_k7_matches_plain_on_card(gen, cuda_device, n, b):
    primes = PRIMES52[:3]
    x = (_u32(gen, (b, n), cuda_device), _u32(gen, (b, n), cuda_device))
    _same_pair(mxu64_cuda.fwd_multi(x, primes), mxu64_cuda.fwd_multi_plain(x, primes))
    fl, fr = ((_u32(gen, (3, b, n), cuda_device), _u32(gen, (3, b, n), cuda_device))
              for _ in range(2))
    scales = tuple(pow(n, p - 2, p) * pow(2, 64, p) % p for p in primes)
    _same_pair(mxu64_cuda.pointwise_inv_multi(fl, fr, primes, scales),
               mxu64_cuda.pointwise_inv_multi_plain(fl, fr, primes, scales))


@pytest.mark.parametrize("regime", list(REGIMES64))
def test_prime64_polymul_on_card_matches_cpu(gen, cuda_device, regime):
    p, n = REGIMES64[regime], 1 << 14
    lhs, rhs = (gen.integers(0, 1 << 64, (3, n), dtype=np.uint64) % np.uint64(p) for _ in range(2))
    profiling.reset_launches()
    got = prime64.Plan.new(n, p).negacyclic_polymul(lhs, rhs)  # numpy input, default device
    assert mxu64_cuda.LAUNCHES["fwd64"] == 2 and mxu64_cuda.LAUNCHES["inv64"] == 1
    np.testing.assert_array_equal(
        got, prime64.Plan.new(n, p, device="cpu").negacyclic_polymul(lhs, rhs))


def test_plan52_polymul_on_card_matches_cpu_and_plan32(gen, cuda_device):
    n, b = 1 << 14, 3
    lhs, rhs = (gen.integers(0, 1 << 64, (b, n), dtype=np.uint64) for _ in range(2))
    profiling.reset_launches()
    got = native64.Plan52.try_new(n).negacyclic_polymul(lhs, rhs)
    assert mxu64_cuda.LAUNCHES == {**dict.fromkeys(mxu64_cuda.LAUNCHES, 0), "fwd_multi64": 2,
                                   "pointwise_inv_multi64": 1}
    np.testing.assert_array_equal(
        got, native64.Plan52.try_new(n, device="cpu").negacyclic_polymul(lhs, rhs))
    np.testing.assert_array_equal(got, native64.Plan32.try_new(n).negacyclic_polymul(lhs, rhs))


def test_product_u64_channel_on_card_matches_cpu(gen, cuda_device):
    n = 1 << 14
    factors = (PRIMES[0], _lp(1 << 15, 1, 1 << 33, 1 << 34))
    m = factors[0] * factors[1]
    a, c = (gen.integers(0, 1 << 64, (3, n), dtype=np.uint64) % np.uint64(m) for _ in range(2))
    got = product.Plan.new(n, m, factors).negacyclic_polymul(a, c)
    np.testing.assert_array_equal(
        got, product.Plan.new(n, m, factors, device="cpu").negacyclic_polymul(a, c))


def _scale64(n, p):
    return pow(n, p - 2, p) * pow(2, 64, p) % p


@pytest.mark.parametrize("regime", list(HYB64))
def test_k5h_matches_plain_and_direct_on_card(gen, cuda_device, regime):
    """K5 with block tables at n = 2^15, n_h = 2^14: the block transforms
    against their plain version, and the whole hybrid (prefix + K5h, K5h +
    suffix) against the direct kernel K5 at 2^15 (bit-identical by
    contract) on full-range u64 operands."""
    p, n, n_h, b = HYB64[regime], 1 << 15, 1 << 14, 3
    x = (_u32(gen, (b, n), cuda_device), _u32(gen, (b, n), cuda_device))
    s = _scale64(n, p)
    profiling.reset_launches()
    _same_pair(mxu64_cuda.fwd_hyb(x, n=n, p=p, n_h=n_h),
               mxu64_cuda.fwd_hyb_plain(x, n=n, p=p, n_h=n_h))
    _same_pair(mxu64_cuda.inv_hyb(x, n=n, p=p, n_h=n_h, scale=s),
               mxu64_cuda.inv_hyb_plain(x, n=n, p=p, n_h=n_h, scale=s))
    _same_pair(stagesplit.fwd64_fused(x, n=n, p=p), mxu64_cuda.fwd(x, n=n, p=p))
    _same_pair(stagesplit.inv64_fused(x, n=n, p=p, scale=s), mxu64_cuda.inv(x, n=n, p=p, scale=s))
    _same_pair(stagesplit.inv64_fused(x, n=n, p=p), stagesplit.inv64(x, n=n, p=p))
    assert mxu64_cuda.LAUNCHES["fwd64_hyb"] == 2 and mxu64_cuda.LAUNCHES["inv64_hyb"] == 3


@pytest.mark.parametrize("n,b", [(1 << 11, 3), (1 << 14, 5)])
def test_k7b_k7c_match_plain_on_card(gen, cuda_device, n, b):
    primes = PRIMES52[:3]
    x = (_u32(gen, (3, b, n), cuda_device), _u32(gen, (3, b, n), cuda_device))
    _same_pair(mxu64_cuda.fwd_multi_perchannel64(*x, primes),
               mxu64_cuda.fwd_multi_perchannel64_plain(x, primes))
    for scales in ((1, 1, 1), tuple(_scale64(n, p) for p in primes)):
        _same_pair(mxu64_cuda.inv_multi(*x, primes, scales),
                   mxu64_cuda.inv_multi_plain(x, primes, scales))


def test_k7_block_tables_match_plain_and_direct_on_card(gen, cuda_device):
    """K7c / K7b / K7d with block tables at n = 2^15: against their plain
    versions, and the channel-grid hybrid against K7a / K5 / K7d direct."""
    primes, n, n_h, b = PRIMES52[:3], 1 << 15, 1 << 14, 3
    scales = tuple(_scale64(n, p) for p in primes)
    x = (_u32(gen, (3, b, n), cuda_device), _u32(gen, (3, b, n), cuda_device))
    y = (_u32(gen, (3, b, n), cuda_device), _u32(gen, (3, b, n), cuda_device))
    _same_pair(mxu64_cuda.fwd_multi_perchannel64(*x, primes, n_h=n_h),
               mxu64_cuda.fwd_multi_perchannel64_plain(x, primes, n_h))
    _same_pair(mxu64_cuda.inv_multi(*x, primes, scales, n_h=n_h),
               mxu64_cuda.inv_multi_plain(x, primes, scales, n_h))
    _same_pair(mxu64_cuda.pointwise_inv_multi(x, y, primes, scales, n_h=n_h),
               mxu64_cuda.pointwise_inv_multi_plain(x, y, primes, scales, n_h))
    shared = (x[0][0], x[1][0])
    _same_pair(stagesplit.fwd_multi_hybrid64(shared, primes, n=n),
               mxu64_cuda.fwd_multi(shared, primes))
    want = [mxu64_cuda.inv((x[0][c], x[1][c]), n=n, p=p, scale=scales[c])
            for c, p in enumerate(primes)]
    _same_pair(stagesplit.inv_multi_hybrid64(*x, primes, scales, n=n),
               tuple(torch.stack([w[i] for w in want]) for i in range(2)))
    _same_pair(stagesplit.pointwise_inv_multi_hybrid64(x, y, primes, scales, n=n),
               mxu64_cuda.pointwise_inv_multi(x, y, primes, scales))


@pytest.mark.parametrize("regime", ["goldilocks", "p62"])
def test_prime64_hybrid_polymul_on_card_matches_cpu(gen, cuda_device, regime):
    p, n = HYB64[regime], 1 << 16
    lhs, rhs = (gen.integers(0, 1 << 64, (2, n), dtype=np.uint64) % np.uint64(p) for _ in range(2))
    profiling.reset_launches()
    got = prime64.Plan.new(n, p).negacyclic_polymul(lhs, rhs)  # numpy input, default device
    assert mxu64_cuda.LAUNCHES == {**dict.fromkeys(mxu64_cuda.LAUNCHES, 0), "fwd64_hyb": 2,
                                   "inv64_hyb": 1}
    np.testing.assert_array_equal(
        got, prime64.Plan.new(n, p, device="cpu").negacyclic_polymul(lhs, rhs))


# -- the u128 operand (four limbs) and the other native plans --------------------


@pytest.mark.parametrize("n,b", [(1 << 11, 3), (1 << 14, 5), (1 << 15, 2)])
@pytest.mark.parametrize("channels", [10, 5])
def test_k1a_u128_matches_plain_on_card(gen, cuda_device, n, b, channels):
    primes = NATIVE128_PRIMES[:channels]
    limbs = tuple(_u32(gen, (b, n), cuda_device) for _ in range(4))  # full-range u128
    profiling.reset_launches()
    got = mxu32_cuda.fwd_wide_multi(limbs, primes)
    assert mxu32_cuda.LAUNCHES == {**dict.fromkeys(mxu32_cuda.LAUNCHES, 0),
                                   "fwd_wide_multi_u128": 1}
    _same(got, mxu32_cuda.fwd_wide_multi_plain(limbs, primes))


@pytest.mark.parametrize("regime", list(BENCH))
def test_k2_k3_u128_match_plain_on_card(gen, cuda_device, regime):
    p, n, b = BENCH[regime], 1 << 14, 3
    xs = tuple(_u32(gen, (b, n), cuda_device) for _ in range(4))
    _same(mxu32_cuda.fwd_wide(xs, n=n, p=p), mxu32_cuda.fwd_wide_plain(xs, n=n, p=p))
    n = 4096
    tbl = mxu32._mxu_tables(n, p)
    n1, n2 = tbl["n1"], tbl["n2"]
    d = tuple(torch.from_numpy(a).to(cuda_device) for a in tbl["d"])
    xa = tuple(_u32(gen, (b, n2, n1), cuda_device) for _ in range(4))
    kw = dict(n=n, p=p, which="A", diag_slices=d, n_limbs=4)
    _same(mxu32_cuda.pass_matmod(xa, **kw), mxu32_cuda.pass_matmod_plain(xa, **kw))


def _plan_pair(module, tier, n):
    cls = getattr(module, tier)
    return cls.try_new(n), cls.try_new(n, device="cpu")  # the default device is the card


NATIVE_PLANS = [(native32, "Plan32"), (native32, "Plan52"), (native_binary32, "Plan32"),
                (native_binary32, "Plan52"), (native_binary64, "Plan32"),
                (native_binary64, "Plan52"), (native128, "Plan32"), (native_binary128, "Plan32")]


@pytest.mark.parametrize("n", [1024, 1 << 11, 1 << 14])
@pytest.mark.parametrize("module,tier", NATIVE_PLANS,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}-{t}" for m, t in NATIVE_PLANS])
def test_native_plan_on_card_matches_cpu(gen, cuda_device, module, tier, n):
    plan, cpu_plan = _plan_pair(module, tier, n)
    b, nl = 2, plan.width // 32
    binary = "binary" in module.__name__
    lhs = tuple(_u32(gen, (b, n), "cpu") for _ in range(nl))
    bits = tuple(_u32(gen, (b, n), "cpu", 2 if i == 0 else 1) for i in range(nl))  # {0, 1}
    rhs = bits if binary else tuple(_u32(gen, (b, n), "cpu") for _ in range(nl))
    as_arg = lambda limbs, dev: limbs[0].to(dev) if nl == 1 else tuple(t.to(dev) for t in limbs)
    as_tuple = lambda out: (out,) if nl == 1 else out
    profiling.reset_launches()
    got = as_tuple(plan.negacyclic_polymul(as_arg(lhs, cuda_device), as_arg(rhs, cuda_device)))
    if tier == "Plan32" and n >= 1 << 11:
        wide = "fwd_wide_multi_u128" if nl == 4 else "fwd_wide_multi"
        want = {**dict.fromkeys(mxu32_cuda.LAUNCHES, 0), "inv_multi": 1}
        want[wide] += 1
        want["fwd_wide_multi" if binary else wide] += 1
        assert mxu32_cuda.LAUNCHES == want
    elif tier == "Plan32":  # the per-channel route: K4 per channel, no K1 launch
        k = len(plan.primes)
        assert butterfly32_cuda.LAUNCHES == {"fwd": 2 * k, "inv": k}
        assert not any(mxu32_cuda.LAUNCHES.values())
    want = as_tuple(cpu_plan.negacyclic_polymul(as_arg(lhs, "cpu"), as_arg(rhs, "cpu")))
    for g, w in zip(got, want):
        _same(g, w)
    f = plan.fwd(as_arg(lhs, cuda_device))
    _same(f, cpu_plan.fwd(as_arg(lhs, "cpu")))
    _same(plan.fwd_binary(as_arg(bits, cuda_device)), cpu_plan.fwd_binary(as_arg(bits, "cpu")))
    back = plan.inv(f, out_format="u32" if nl == 1 else "planar")
    for g, w in zip(as_tuple(back),
                    as_tuple(cpu_plan.inv(f.cpu(), out_format="u32" if nl == 1 else "planar"))):
        _same(g, w)


def test_native128_host_formats_on_default_plan(gen, cuda_device):
    n = 1 << 11
    plan, cpu_plan = _plan_pair(native128, "Plan32", n)
    a = [int.from_bytes(gen.bytes(16), "little") for _ in range(n)]
    b = [int.from_bytes(gen.bytes(16), "little") for _ in range(n)]
    profiling.reset_launches()
    got = plan.negacyclic_polymul(a, b)  # Python ints move to the card
    assert mxu32_cuda.LAUNCHES["fwd_wide_multi_u128"] == 2
    assert got == cpu_plan.negacyclic_polymul(a, b)


def test_native_plan_above_2_15_raises_on_card(gen, cuda_device):
    """Kept under its old name: above 2^15 a native plan now computes on the
    card (K1a / K1b at n = 2^16) and equals the CPU plain path."""
    n = 1 << 16
    plan, cpu_plan = _plan_pair(native64, "Plan32", n)
    x, y = (tuple(_u32(gen, (1, n), "cpu") for _ in range(2)) for _ in range(2))
    on_card = lambda limbs: tuple(t.to(cuda_device) for t in limbs)
    profiling.reset_launches()
    got = plan.negacyclic_polymul(on_card(x), on_card(y))
    assert mxu32_cuda.LAUNCHES == {**dict.fromkeys(mxu32_cuda.LAUNCHES, 0),
                                   "fwd_wide_multi": 2, "inv_multi": 1}
    _same_pair(got, cpu_plan.negacyclic_polymul(x, y))
    _same(plan.fwd(on_card(x)), cpu_plan.fwd(x))


# -- n = 2^16 and 2^17, block tables, the presplit inverse, K5's u128 operand ----

# the three prime32 regimes with 2^18 | p - 1: NTT primes up to n = 2^17
BIG32 = {
    "lt30": _lp(1 << 18, 1, 1 << 29, 1 << 30),
    "lt31": _lp(1 << 18, 1, 1 << 30, 1 << 31),
    "generic": _lp(1 << 18, 1, 1 << 31, 1 << 32),
}


def _scale32(n, p):
    return pow(n, p - 2, p) * pow(2, 32, p) % p


@pytest.mark.parametrize("n,b", [(1 << 16, 3), (1 << 17, 2)])
def test_k1_matches_plain_above_2_15_on_card(gen, cuda_device, n, b):
    from concrete_ntt_tpu_torch.tables import primes32_ext

    primes = primes32_ext()[:5]
    limbs = tuple(_u32(gen, (b, n), cuda_device) for _ in range(4))
    for nl in (1, 2, 4):
        _same(mxu32_cuda.fwd_wide_multi(limbs[:nl], primes),
              mxu32_cuda.fwd_wide_multi_plain(limbs[:nl], primes))
    p3 = primes[:3]
    xs = (_u32(gen, (3, b, n), cuda_device), _u32(gen, (3, b, n), cuda_device))
    scales = tuple(_scale32(n, p) for p in p3)
    _same(mxu32_cuda.inv_multi(xs[0], p3, scales), mxu32_cuda.inv_multi_plain(xs[0], p3, scales))
    _same(mxu32_cuda.fwd_multi_perchannel(xs[0], p3),
          mxu32_cuda.fwd_multi_perchannel_plain(xs[:1], p3))
    _same(mxu32_cuda.fwd_wide_multi_perchannel(*xs, p3),
          mxu32_cuda.fwd_multi_perchannel_plain(xs, p3))
    _same(mxu32_cuda.pointwise_inv_multi(*xs, p3, scales),
          mxu32_cuda.pointwise_inv_multi_plain(*xs, p3, scales))


@pytest.mark.parametrize("regime", list(BIG32))
@pytest.mark.parametrize("n,b", [(1 << 16, 3), (1 << 17, 2)])
def test_k2_k3_match_plain_above_2_15_on_card(gen, cuda_device, regime, n, b):
    p = BIG32[regime]
    xs = tuple(_u32(gen, (b, n), cuda_device) for _ in range(4))
    _same(mxu32_cuda.fwd(xs[0], n=n, p=p), mxu32_cuda.fwd_plain(xs[0], n=n, p=p))
    for nl in (2, 4):
        _same(mxu32_cuda.fwd_wide(xs[:nl], n=n, p=p), mxu32_cuda.fwd_wide_plain(xs[:nl], n=n, p=p))
    for s in (1, _scale32(n, p)):
        _same(mxu32_cuda.inv(xs[0], n=n, p=p, scale=s),
              mxu32_cuda.inv_plain(xs[0], n=n, p=p, scale=s))
    tbl = mxu32._mxu_tables(n, p)
    n1, n2 = tbl["n1"], tbl["n2"]
    d = tuple(torch.from_numpy(a[: n2 // 4]).to(cuda_device) for a in tbl["d"])
    xa = tuple(_u32(gen, (b, n2 // 4, n1), cuda_device) for _ in range(4))  # 4096 contraction rows
    kw = dict(n=n, p=p, which="A", diag_slices=d, n_limbs=4)
    _same(mxu32_cuda.pass_matmod(xa, **kw), mxu32_cuda.pass_matmod_plain(xa, **kw))


# the hybrid's regimes: BIG32 (its "generic" prime takes five digit planes) and
# a generic prime with four
HYB32 = {**BIG32, "generic4": _lp(1 << 18, 1, 1 << 31, 3 << 30)}


@pytest.mark.parametrize("regime", list(HYB32))
@pytest.mark.parametrize("n,b", [(1 << 15, 3), (1 << 16, 3), (1 << 17, 2), (1 << 16, 1),
                                 (1 << 16, 16), (1 << 17, 1), (1 << 17, 16)])
def test_k2_block_tables_match_plain_and_direct_on_card(gen, cuda_device, regime, n, b):
    """K2 with block tables (n_h = 2^14): the block transforms on the tile
    codes `k2h_tiles` picks against their plain version (launches counted
    under those codes in `TILE_LAUNCHES`), every other pair of codes forced
    against them, and the whole 32-bit hybrid against the direct kernel at
    the same n on full-range u32 operands."""
    p, n_h = HYB32[regime], 1 << 14
    n_d = mxu32._n_dplanes32(p)
    assert n_d == (5 if regime == "generic" else 4)
    x = _u32(gen, (b, n), cuda_device)
    s = _scale32(n, p)
    profiling.reset_launches()
    fwd = mxu32_cuda.fwd_hyb(x, n=n, p=p, n_h=n_h)
    inv = mxu32_cuda.inv_hyb(x, n=n, p=p, n_h=n_h, scale=s)
    _same(fwd, mxu32_cuda.fwd_hyb_plain(x, n=n, p=p, n_h=n_h))
    _same(inv, mxu32_cuda.inv_hyb_plain(x, n=n, p=p, n_h=n_h, scale=s))
    rule = {d: mxu32_cuda.k2h_tiles(b, n, n_h, d, n_d) for d in ("fwd", "inv")}
    assert mxu32_cuda.TILE_LAUNCHES == {("fwd_hyb", *rule["fwd"]): 1,
                                        ("inv_hyb", *rule["inv"]): 1}
    _same(stagesplit.engine32_fused.fwd(x, n=n, p=p), mxu32_cuda.fwd(x, n=n, p=p))
    _same(stagesplit.engine32_fused.inv(x, n=n, p=p, scale=s), mxu32_cuda.inv(x, n=n, p=p, scale=s))
    assert mxu32_cuda.LAUNCHES == {**dict.fromkeys(mxu32_cuda.LAUNCHES, 0), "fwd_hyb": 2,
                                   "inv_hyb": 2, "fwd": 1, "inv": 1}
    codes = [(t1, t2) for t1 in range(3) for t2 in range(4) if t2 < 3 or n_d == 4]
    rule_tiles = mxu32_cuda.k2h_tiles
    profiling.reset_launches()
    try:
        for c in codes:
            mxu32_cuda.k2h_tiles = lambda *a, c=c, **k: c
            _same(mxu32_cuda.fwd_hyb(x, n=n, p=p, n_h=n_h), fwd)
            _same(mxu32_cuda.inv_hyb(x, n=n, p=p, n_h=n_h, scale=s), inv)
    finally:
        mxu32_cuda.k2h_tiles = rule_tiles
    assert mxu32_cuda.TILE_LAUNCHES == {(name, *c): 1 for c in codes
                                        for name in ("fwd_hyb", "inv_hyb")}


@pytest.mark.parametrize("n,b", [(1 << 15, 3), (1 << 16, 2)])
def test_k1_block_tables_match_plain_and_direct_on_card(gen, cuda_device, n, b):
    """K1c (1 and 2 limbs) / K1b / K1d with block tables against their plain
    versions, and the four channel-grid hybrids against K1a / K1c / K1b / K1d
    direct."""
    from concrete_ntt_tpu_torch.tables import primes32_ext

    primes = (PRIMES if n <= 1 << 15 else primes32_ext())[:3]
    n_h = 1 << 14
    scales = tuple(_scale32(n, p) for p in primes)
    x, y = (_u32(gen, (3, b, n), cuda_device) for _ in range(2))
    _same(mxu32_cuda.fwd_multi_perchannel(x, primes, n_h=n_h),
          mxu32_cuda.fwd_multi_perchannel_plain((x,), primes, n_h))
    _same(mxu32_cuda.fwd_wide_multi_perchannel(x, y, primes, n_h=n_h),
          mxu32_cuda.fwd_multi_perchannel_plain((x, y), primes, n_h))
    _same(mxu32_cuda.inv_multi(x, primes, scales, n_h=n_h),
          mxu32_cuda.inv_multi_plain(x, primes, scales, n_h))
    _same(mxu32_cuda.pointwise_inv_multi(x, y, primes, scales, n_h=n_h),
          mxu32_cuda.pointwise_inv_multi_plain(x, y, primes, scales, n_h))
    profiling.reset_launches()
    for limbs in ((x[0],), (x[0], y[0])):
        _same(stagesplit.fwd_wide_multi_hybrid32(limbs, primes, n=n),
              mxu32_cuda.fwd_wide_multi(limbs, primes))
    _same(stagesplit.fwd_perchannel_multi_hybrid32(x, primes, n=n),
          mxu32_cuda.fwd_multi_perchannel(x, primes))
    _same(stagesplit.inv_multi_hybrid32(x, primes, scales, n=n),
          mxu32_cuda.inv_multi(x, primes, scales))
    _same(stagesplit.pointwise_inv_multi_hybrid32(x, y, primes, scales, n=n),
          mxu32_cuda.pointwise_inv_multi(x, y, primes, scales))
    assert mxu32_cuda.LAUNCHES == {**dict.fromkeys(mxu32_cuda.LAUNCHES, 0),
                                   "fwd_multi_perchannel_hyb": 3, "inv_multi_hyb": 1,
                                   "pointwise_inv_multi_hyb": 1, "fwd_wide_multi": 2,
                                   "fwd_multi_perchannel": 1, "inv_multi": 1,
                                   "pointwise_inv_multi": 1}


@pytest.mark.parametrize("n,b,c", [(1 << 11, 3, 5), (1 << 14, 5, 5), (1 << 16, 2, 5),
                                   (1 << 14, 1, 2), (1 << 14, 8, 5), (1 << 14, 16, 2),
                                   (1 << 14, 16, 10)])
def test_k1e_presplit_matches_k1b_on_card(gen, cuda_device, n, b, c):
    """K1e on the codes `_k1e_tiles` picks (counted under them in
    `TILE_LAUNCHES`) against its plain version and K1b on the values, then
    every pair of codes its passes take forced against K1b (n >= 2^12: the
    second pass's 64-output tile needs n1 % 64 == 0)."""
    from concrete_ntt_tpu_torch.tables import primes32_ext

    primes = ((PRIMES if c <= 5 else NATIVE128_PRIMES) if n <= 1 << 15 else primes32_ext())[:c]
    scales = tuple(_scale32(n, p) for p in primes)
    x = _u32(gen, (c, b, n), cuda_device)
    xd = mxu32_cuda.digit_planes32(x)
    profiling.reset_launches()
    got = mxu32_cuda.inv_multi_presplit(xd, primes, scales)
    assert mxu32_cuda.LAUNCHES == {**dict.fromkeys(mxu32_cuda.LAUNCHES, 0),
                                   "inv_multi_presplit": 1}
    rule = mxu32_cuda._k1e_tiles(b, n, c)
    assert mxu32_cuda.TILE_LAUNCHES == {("inv_multi_presplit", *rule): 1}
    _same(got, mxu32_cuda.inv_multi_presplit_plain(xd, primes, scales))
    k1b = mxu32_cuda.inv_multi(x, primes, scales)
    _same(got, k1b)
    codes = [(t1, t2) for t1 in range(3) for t2 in range(4 if n >= 1 << 12 else 3)]
    rule_tiles = mxu32_cuda._k1e_tiles
    profiling.reset_launches()
    try:
        for codes_ in codes:
            mxu32_cuda._k1e_tiles = lambda *a, c=codes_: c
            _same(mxu32_cuda.inv_multi_presplit(xd, primes, scales), k1b)
    finally:
        mxu32_cuda._k1e_tiles = rule_tiles
    assert mxu32_cuda.TILE_LAUNCHES == {("inv_multi_presplit", *t): 1 for t in codes}


@pytest.mark.parametrize("instance", list(INSTANCES64))
@pytest.mark.parametrize("n,b", [(1 << 14, 3), (1 << 11, 3)])
def test_k5_u128_matches_plain_on_card(gen, cuda_device, instance, n, b):
    p = INSTANCES64[instance]
    x = tuple(_u32(gen, (b, n), cuda_device) for _ in range(4))
    profiling.reset_launches()
    got = mxu64_cuda.fwd(x, n=n, p=p)
    assert mxu64_cuda.LAUNCHES == {**dict.fromkeys(mxu64_cuda.LAUNCHES, 0), "fwd64_u128": 1}
    _same_pair(got, mxu64_cuda.fwd_plain(x, n=n, p=p))


@pytest.mark.parametrize("module,n", [(native128, 1 << 16), (native64, 1 << 17),
                                      (native_binary32, 1 << 16)],
                         ids=["native128-2^16", "native64-2^17", "native_binary32-2^16"])
def test_native_plan32_above_2_15_on_card_matches_cpu(gen, cuda_device, module, n):
    plan, cpu_plan = _plan_pair(module, "Plan32", n)
    nl = plan.width // 32
    binary = "binary" in module.__name__
    lhs = tuple(_u32(gen, (1, n), "cpu") for _ in range(nl))
    rhs = tuple(_u32(gen, (1, n), "cpu", 2 if binary else 1 << 32) for _ in range(nl))
    as_arg = lambda limbs, dev: limbs[0].to(dev) if nl == 1 else tuple(t.to(dev) for t in limbs)
    as_tuple = lambda out: (out,) if nl == 1 else out
    got = as_tuple(plan.negacyclic_polymul(as_arg(lhs, cuda_device), as_arg(rhs, cuda_device)))
    want = as_tuple(cpu_plan.negacyclic_polymul(as_arg(lhs, "cpu"), as_arg(rhs, "cpu")))
    _same_pair(got, want)


@pytest.mark.parametrize("regime", list(BIG32))
@pytest.mark.parametrize("n", [1 << 16, 1 << 17])
def test_prime32_polymul_above_2_15_on_card_matches_cpu(gen, cuda_device, regime, n):
    p = BIG32[regime]
    lhs, rhs = (gen.integers(0, p, (2, n), dtype=np.uint32) for _ in range(2))
    profiling.reset_launches()
    got = prime32.Plan.new(n, p).negacyclic_polymul(lhs, rhs)  # numpy input, default device
    assert mxu32_cuda.LAUNCHES == {**dict.fromkeys(mxu32_cuda.LAUNCHES, 0), "fwd": 2, "inv": 1}
    _same(got, prime32.Plan.new(n, p, device="cpu").negacyclic_polymul(lhs, rhs))


def test_small_prime_above_2_15_launches_k4_on_card(gen, cuda_device):
    """Formerly test_small_prime_above_2_15_raises_on_card: a prime below
    2^26 above 2^15 has no four-step; the plan takes K4 on the card (a
    cluster of blocks a polynomial; tier "K4" up to 2^17): fwd (K4 fwd +1),
    inv (inv +1) and the polymul (fwd +2, inv +1) equal the CPU, no
    four-step kernel launches, and K4's range ends at 2^17."""
    n, p = 1 << 16, _lp(1 << 17, 1, 0, 1 << 26)
    plan, cpu = prime32.Plan.new(n, p), prime32.Plan.new(n, p, device="cpu")
    x = _u32(gen, (1, n), cuda_device, p)
    lhs, rhs = (gen.integers(0, p, (1, n), dtype=np.uint32) for _ in range(2))
    profiling.reset_launches()
    _same(plan.fwd(x), cpu.fwd(x.cpu()))
    _same(plan.inv(x), cpu.inv(x.cpu()))
    _same(plan.negacyclic_polymul(lhs, rhs), cpu.negacyclic_polymul(lhs, rhs))
    assert butterfly32_cuda.LAUNCHES == {"fwd": 3, "inv": 2}
    assert not any(mxu32_cuda.LAUNCHES.values())
    with pytest.raises(NotImplementedError, match="K4"):
        butterfly32_cuda.check_range(1 << 18, plan.variant)


# the prime32 regimes with 2^18 | p - 1 for K2 up to 2^17: lt30, lt31,
# generic with four matrix digit planes and with five (a prime near 2^32)
K2_PRIMES = {"lt30": BIG32["lt30"], "lt31": BIG32["lt31"],
             "generic": _lp(1 << 18, 1, 1 << 31, 255 << 24), "generic-5planes": 4293918721}


@pytest.mark.parametrize("n", [1 << k for k in range(11, 18)])
@pytest.mark.parametrize("regime", list(K2_PRIMES))
def test_k2_tiles_match_plain_at_every_size_on_card(gen, cuda_device, regime, n):
    """K2 on its tiles (K1's 128 x 32, or 64 x 16 with the contraction held
    whole for one channel's small grids: mxu32_cuda.k2_tile) at every size
    and B in {1, 3, 16}: fwd, fwd with two limbs, scaled inv."""
    p = K2_PRIMES[regime]
    assert mxu32._n_dplanes32(p) == (5 if regime == "generic-5planes" else 4)
    for b in (1, 3, 16):
        xs = (_u32(gen, (b, n), cuda_device), _u32(gen, (b, n), cuda_device))
        _same(mxu32_cuda.fwd(xs[0], n=n, p=p), mxu32_cuda.fwd_plain(xs[0], n=n, p=p))
        _same(mxu32_cuda.fwd_wide(xs, n=n, p=p), mxu32_cuda.fwd_wide_plain(xs, n=n, p=p))
        s = pow(n, p - 2, p) * pow(2, 32, p) % p
        _same(mxu32_cuda.inv(xs[1], n=n, p=p, scale=s),
              mxu32_cuda.inv_plain(xs[1], n=n, p=p, scale=s))


# K4's regimes with 2^18 | p - 1, and a prime below 2^26
K4_PRIMES = {**BIG32, "small": _lp(1 << 18, 1, 0, 1 << 26)}


# batches beyond {1, 9, 16} by n: B = 80 at 2^14 (clusters of 2 blocks, as
# at n = 512), B = 132 at 2^15 and 2^17 (a block of 2^15 values: c = 1, 4)
K4_MORE_BATCHES = {1 << 14: (80,), 1 << 15: (132,), 1 << 17: (132,)}


@pytest.mark.parametrize("n", [2, 32, 512, 1024, 2048, 4096, 1 << 14, 1 << 15, 1 << 16,
                               1 << 17])
@pytest.mark.parametrize("regime", list(K4_PRIMES))
def test_k4_clusters_match_plain_on_card(gen, cuda_device, regime, n):
    """K4 at B in {1, 9, 16} (c = butterfly32_cuda.cluster_size: one block of
    whole polynomials below 2^9, clusters of 2 to 8 blocks above; 9 leaves a
    ragged last block below 1024) and the batches of K4_MORE_BATCHES, so that
    every cluster size runs in every regime."""
    p = K4_PRIMES[regime]
    plan = prime32.Plan.new(n, p)
    kw = dict(p=p, variant=plan.variant, p_neginv=plan.p_neginv)
    for b in (1, 9, 16) + K4_MORE_BATCHES.get(n, ()):
        x = _u32(gen, (b, n), cuda_device, p)
        _same(butterfly32_cuda.try_fwd(x, plan._tbl, **kw),
              butterfly32_cuda.fwd_plain(x, plan._tbl, **kw))
        _same(butterfly32_cuda.try_inv(x, plan._tbl, **kw),
              butterfly32_cuda.inv_plain(x, plan._tbl, **kw))


@pytest.mark.parametrize("n,b", [(1 << 11, 1), (1 << 11, 2), (1 << 12, 3), (1 << 13, 5)])
def test_tensor_core_pass_small_and_ragged_shapes_on_card(gen, cuda_device, n, b):
    """The tensor-core pass at its smallest contraction (n = 2^11: 32 words,
    one ring stage) and batches that leave a ragged last row tile: K1a with
    1, 2 and 4 limbs, K1b, K2 fwd / fwd_wide / inv in lt30 and with five
    digit planes, K3 on a row slice."""
    limbs = tuple(_u32(gen, (b, n), cuda_device) for _ in range(4))
    for nl in (1, 2, 4):
        _same(mxu32_cuda.fwd_wide_multi(limbs[:nl], PRIMES),
              mxu32_cuda.fwd_wide_multi_plain(limbs[:nl], PRIMES))
    x = _u32(gen, (len(PRIMES), b, n), cuda_device)
    sc = tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in PRIMES)
    _same(mxu32_cuda.inv_multi(x, PRIMES, sc), mxu32_cuda.inv_multi_plain(x, PRIMES, sc))
    for p in (BENCH["lt30"], BENCH["generic"]):
        _same(mxu32_cuda.fwd(limbs[0], n=n, p=p), mxu32_cuda.fwd_plain(limbs[0], n=n, p=p))
        _same(mxu32_cuda.fwd_wide(limbs, n=n, p=p), mxu32_cuda.fwd_wide_plain(limbs, n=n, p=p))
        _same(mxu32_cuda.inv(limbs[1], n=n, p=p, scale=3),
              mxu32_cuda.inv_plain(limbs[1], n=n, p=p, scale=3))
        tbl = mxu32._mxu_tables(n, p)
        n1, n2 = tbl["n1"], tbl["n2"]
        d = tuple(torch.from_numpy(a[n2 // 4: n2 // 4 + n2 // 2]).to(cuda_device) for a in tbl["d"])
        xa = _u32(gen, (b, n2 // 2, n1), cuda_device)
        kw = dict(n=n, p=p, which="A", diag_slices=d)
        _same(mxu32_cuda.pass_matmod(xa, **kw), mxu32_cuda.pass_matmod_plain(xa, **kw))


def test_k2_five_digit_planes_on_card(gen, cuda_device):
    """A prime near 2^32 takes a fifth matrix digit plane (kD = 5: a wider N
    axis of the tensor-core tile and the bit-32 add of the combine)."""
    p = 4294828033  # 0xfffde001, 2^13 | p - 1
    assert mxu32._n_dplanes32(p) == 5
    for n, b in ((1 << 11, 3), (1 << 12, 2)):
        xs = tuple(_u32(gen, (b, n), cuda_device) for _ in range(2))
        _same(mxu32_cuda.fwd_wide(xs, n=n, p=p), mxu32_cuda.fwd_wide_plain(xs, n=n, p=p))
        s = pow(n, p - 2, p) * pow(2, 32, p) % p
        _same(mxu32_cuda.inv(xs[0], n=n, p=p, scale=s),
              mxu32_cuda.inv_plain(xs[0], n=n, p=p, scale=s))


def test_misaligned_operand_raises_on_card(gen, cuda_device):
    """The passes copy 16-byte chunks: an operand that starts off a 16-byte
    boundary raises instead of launching (the 64-bit wrappers name it)."""
    n = 1 << 11
    base = _u32(gen, (2 * n + 1,), cuda_device)
    x = base[1:1 + 2 * n].view(2, n)  # contiguous, 4 bytes past an aligned start
    before = dict(mxu32_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        mxu32_cuda.fwd(x, n=n, p=BENCH["lt30"])
    assert mxu32_cuda.LAUNCHES == before
    _same(mxu32_cuda.fwd(x.clone(), n=n, p=BENCH["lt30"]),
          mxu32_cuda.fwd_plain(x, n=n, p=BENCH["lt30"]))
    p, lo = PRIMES52[0], _u32(gen, (2, n), cuda_device)
    before = dict(mxu64_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="x_hi must start on a 16-byte"):
        mxu64_cuda.fwd((lo, x), n=n, p=p)
    assert mxu64_cuda.LAUNCHES == before
    _same_pair(mxu64_cuda.fwd((lo, x.clone()), n=n, p=p), mxu64_cuda.fwd_plain((lo, x), n=n, p=p))


# K3's channel grid: (n, B, s, channels, A-pass limbs) of a rank's four
# passes (A on the value shard, F on the exchange's output, G, A_inv written
# transposed): the sharded routes' rank-local shapes (native128 (2^16, 8) at
# (dp, ch, sp) = (1, 2, 2) and in a world of one, native64 (2^14, 8) at
# (2, 1, 2), four ranks of a 4096 transform), s = 2 and 4, n = 2^11 .. 2^17,
# C = 1-5 and 10, and every tile code `k3_multi_tile` picks (K1's ring;
# 64 x 16; K1's tile holding four stages whole at (2^14, 16, 1, 2); 128 x 64
# for the canonical passes at (4096, 16, 1, 10))
K3_MULTI_SHAPES = ((1 << 16, 8, 2, 5, 4), (1 << 16, 8, 1, 10, 4), (1 << 14, 4, 2, 1, 1),
                   (4096, 16, 4, 1, 1), (1 << 11, 3, 4, 1, 1), (1 << 11, 2, 2, 5, 2),
                   (1 << 12, 4, 2, 3, 4), (1 << 13, 3, 4, 2, 1), (1 << 14, 16, 1, 2, 1),
                   (4096, 16, 1, 10, 1), (1 << 15, 2, 4, 5, 1), (1 << 17, 2, 4, 2, 1))
# K6's: Plan52 (2^14, 8) at (2, 1, 2) and in a world of one (both on the
# 64-row tile), s = 2 and 4, n = 2^11 .. 2^15, C = 1-5; the 128-row tile at
# the eight instances' (2^14, 32, 1, 1)
K6_MULTI_SHAPES = ((1 << 14, 4, 2, 3), (1 << 14, 8, 1, 3), (1 << 11, 3, 4, 1),
                   (1 << 12, 2, 2, 5), (1 << 13, 3, 4, 2), (1 << 15, 2, 2, 3))


def _route_passes(gen, dev, n, b, s, c, limbs, pair=False):
    """The four passes of a rank's transform pair as the sharded routes
    make them, on random operands: (which, operand views, diag, scales,
    transposed_out) with the rank's last rows of d / e; `pair` for limb
    pairs (F / A_inv's second limb below 2^18: mid-pass values)."""
    n1, n2 = mxu32.four_step_factors(n)
    c_, c1 = n2 // s, n1 // s

    def limbs_of(shape, k, mid=False):
        return tuple(_u32(gen, shape, dev, 1 << 18 if mid and i else 1 << 32) for i in range(k))

    one = 2 if pair else 1
    a = tuple(t.transpose(1, 2) for t in limbs_of((b, n1, c_), 2 if pair else limbs))
    f = tuple(t.transpose(2, 3) for t in limbs_of((c, b, n2, c1), one, mid=pair))
    g = limbs_of((c, b, c1, n2), one)
    ai = tuple(t.transpose(2, 3) for t in limbs_of((c, b, n1, c_), one, mid=pair))
    return (("A", a, (n2 - c_, c_)), ("F", f, None), ("G", g, (n1 - c1, c1)),
            ("Ainv", ai, None))


def _k3_multi_primes(n, c):
    from concrete_ntt_tpu_torch.tables import primes32_ext

    return tuple((primes32_ext() if n > 1 << 15 else NATIVE128_PRIMES)[:c])


def test_k3_multi_matches_plain_on_card(gen, cuda_device):
    """`pass_matmod_multi` (csrc/mxu32_pass.cu k3_pass_multi) == its plain
    twin on the same strided views at K3_MULTI_SHAPES, and with one channel
    in each regime (five digit planes included) at n = 4096 and 2^17; every
    tile code of `k3_multi_tile` launched, and nothing but the grid."""
    cases = [(shape, _k3_multi_primes(shape[0], shape[3])) for shape in K3_MULTI_SHAPES]
    cases += [((4096, 3, 2, 1, 2), (p,)) for p in BENCH.values()]
    cases += [((1 << 17, 16, 2, 1, 1), (BENCH["generic"],)), ((1 << 16, 3, 2, 1, 4),
                                                             (BIG32["lt31"],))]
    profiling.reset_launches()
    launched = 0
    for (n, b, s, c, limbs), primes in cases:
        for which, x, rows in _route_passes(gen, cuda_device, n, b, s, c, limbs):
            diag = (mxu32_cuda.multi_diag(n, primes, which, *rows, str(cuda_device))
                    if rows else None)
            kw = dict(n=n, primes=primes, which=which, diag=diag,
                      scales=tuple(pow(n, q - 2, q) * 7 % q for q in primes)
                      if which == "Ainv" else None, transposed_out=which == "Ainv")
            xx = x if len(x) > 1 else x[0]
            _same(mxu32_cuda.pass_matmod_multi(xx, **kw),
                  mxu32_cuda.pass_matmod_multi_plain(xx, **kw))
            launched += 1
    counts = {k: v for k, v in mxu32_cuda.LAUNCHES.items() if v}
    assert sum(counts.values()) == launched
    assert set(counts) == {"pass_matmod_multi", "pass_matmod_multi_u128"}
    assert {k[1] for k in mxu32_cuda.TILE_LAUNCHES} == {0, 1, 2, 3}


def test_k6_multi_matches_plain_on_card(gen, cuda_device):
    """`pass_matmod64_multi` (csrc/mxu64_pass.cu k6_pass_multi) == its plain
    twin on the same strided limb-pair views at K6_MULTI_SHAPES over Plan52
    primes, and with one channel for each of the eight (digit planes,
    regime) instances on both tiles (64 rows at (4096, 3, 2), 128 at
    (2^14, 32, 1)); both tile codes of `k6_tile` launched."""
    cases = [(shape, tuple(PRIMES52[:shape[3]])) for shape in K6_MULTI_SHAPES]
    for p in INSTANCES64.values():
        cases += [((4096, 3, 2, 1), (p,)), ((1 << 14, 32, 1, 1), (p,))]
    profiling.reset_launches()
    for (n, b, s, c), primes in cases:
        for which, x, rows in _route_passes(gen, cuda_device, n, b, s, c, 2, pair=True):
            diag = (mxu64_cuda.multi_diag(n, primes, which, *rows, str(cuda_device))
                    if rows else None)
            kw = dict(n=n, primes=primes, which=which, diag=diag,
                      scales=tuple(pow(n, q - 2, q) * pow(2, 64, q) % q for q in primes)
                      if which == "Ainv" else None, transposed_out=which == "Ainv")
            _same_pair(mxu64_cuda.pass_matmod64_multi(x, **kw),
                       mxu64_cuda.pass_matmod64_multi_plain(x, **kw))
    assert mxu64_cuda.LAUNCHES["pass_matmod64_multi"] == 4 * len(cases)
    assert {k[1] for k in mxu64_cuda.TILE_LAUNCHES} == {0, 1}


def _sharded_rank(rank, world, n):
    """One rank of a world on cuda:0 (tests/test_torch_cuda.py's sharded
    card test): the sharded paths at n through K3 / K6, their outputs and
    launch deltas back to the parent on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    from concrete_ntt_tpu_torch.parallel import channels, fourstep_mxu

    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(7)
    sp = init_device_mesh("cuda", (world,), mesh_dim_names=("sp",))
    ch = init_device_mesh("cuda", (world,), mesh_dim_names=("ch",))
    out, launches = {}, {}
    p = BENCH["lt30"]
    x = gen.integers(0, p, (4, n), dtype=np.uint32)
    profiling.reset_launches()
    fwd, inv, to_dist, from_dist = fourstep_mxu.make_sharded_prime32_mxu(
        prime32.Plan.new(n, p), sp, axis="sp")
    f = fwd(to_dist(torch.from_numpy(x)))
    out["mxu32"] = (from_dist(f).cpu(), from_dist(inv(f)).cpu())
    launches["mxu32"] = {k: v for k, v in mxu32_cuda.LAUNCHES.items() if v}
    p64 = PRIMES52[0]
    x64 = torch.from_numpy(np.stack([gen.integers(0, 1 << 32, (4, n), dtype=np.uint32),
                                     gen.integers(0, 1 << 18, (4, n), dtype=np.uint32)], -1))
    profiling.reset_launches()
    fwd, inv, to_dist, from_dist = fourstep_mxu.make_sharded_prime64_mxu(
        prime64.Plan.new(n, p64), sp, axis="sp")
    f = fwd(to_dist(x64))
    out["mxu64"] = (from_dist(f).cpu(), from_dist(inv(f)).cpu())
    launches["mxu64"] = {k: v for k, v in mxu64_cuda.LAUNCHES.items() if v}
    lhs, rhs = (gen.integers(0, 1 << 32, (2, n, 4), dtype=np.uint32) for _ in range(2))
    plan128 = native128.Plan32.try_new(n)
    profiling.reset_launches()
    for name, mesh, kw in (("ch128", ch, {}), ("sp128", sp, {"sp_axis": "sp"})):
        sh = channels.ChannelShardedNative(plan128, mesh, **kw)
        out[name] = sh.negacyclic_polymul(torch.from_numpy(lhs).to(dev),
                                          torch.from_numpy(rhs).to(dev)).cpu()
    launches["ch128"] = {k: v for k, v in mxu32_cuda.LAUNCHES.items() if v}
    a, b = (gen.integers(0, 1 << 64, (2, n), dtype=np.uint64) for _ in range(2))
    profiling.reset_launches()
    sh = channels.ChannelShardedNative52(native64.Plan52.try_new(n), sp, sp_axis="sp")
    out["ch52"] = sh.negacyclic_polymul(a, b)
    launches["ch52"] = {k: v for k, v in mxu64_cuda.LAUNCHES.items() if v}
    out["route52"] = sh.route
    return out, launches


@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_sharded_paths_on_card(gen, cuda_device, tmp_path, backend, world):
    """The sharded paths (parallel/fourstep_mxu.py, parallel/channels.py) in a
    world of ranks on cuda:0 at n = 4096: gloo with two ranks (NCCL refuses
    two ranks on one card), NCCL with one. Each rank launches K3 / K6's
    channel grids and nothing else (nothing falls back); rank 0's results
    == the CPU plain path."""
    from concrete_ntt_tpu_torch.ops import cuda_build
    from concrete_ntt_tpu_torch.parallel import _dist

    n = 4096
    for name in ("mxu32_pass", "mxu64_pass"):
        cuda_build.build(name)  # once, before the ranks load it
    ranks = _dist.spawn(_sharded_rank, world, str(tmp_path / "store"), (n,), backend=backend,
                        timeout=600)
    gen = np.random.default_rng(7)
    p = BENCH["lt30"]
    plan = prime32.Plan.new(n, p, device="cpu")
    x = torch.from_numpy(gen.integers(0, p, (4, n), dtype=np.uint32))
    plan64 = prime64.Plan.new(n, PRIMES52[0], device="cpu")
    x64 = torch.from_numpy(np.stack([gen.integers(0, 1 << 32, (4, n), dtype=np.uint32),
                                     gen.integers(0, 1 << 18, (4, n), dtype=np.uint32)], -1))
    lhs, rhs = (torch.from_numpy(gen.integers(0, 1 << 32, (2, n, 4), dtype=np.uint32))
                for _ in range(2))
    a, b = (gen.integers(0, 1 << 64, (2, n), dtype=np.uint64) for _ in range(2))
    want128 = native128.Plan32.try_new(n, device="cpu").negacyclic_polymul(lhs, rhs)
    for out, launches in ranks:
        assert torch.equal(out["mxu32"][0], plan.fwd(x))
        assert torch.equal(out["mxu32"][1], plan.inv(plan.fwd(x)))
        assert torch.equal(out["mxu64"][0], plan64.fwd(x64))
        assert torch.equal(out["mxu64"][1], plan64.inv(plan64.fwd(x64)))
        assert torch.equal(out["ch128"], want128) and torch.equal(out["sp128"], want128)
        assert np.array_equal(out["ch52"],
                              native64.Plan52.try_new(n, device="cpu").negacyclic_polymul(a, b))
        # a transform is two passes a rank, each one channel-grid launch; a
        # polymul six launches over all of a rank's channels (two A with the
        # operand's four limbs), for each of the two meshes
        assert launches["mxu32"] == {"pass_matmod_multi": 4}
        assert launches["mxu64"] == {"pass_matmod64_multi": 4}
        assert launches["ch128"] == {"pass_matmod_multi_u128": 2 * 2, "pass_matmod_multi": 4 * 2}
        assert launches["ch52"] == {"pass_matmod64_multi": 6} and out["route52"] == "grid"


def test_plan32_polymul_graph_replay_matches_eager(gen, cuda_device):
    """The native64 Plan32 polymul (2^14, 8) captured as a CUDA graph of two
    dependent polymuls (`utils/profiling.capture`) replays to eager's bits,
    also after its inputs are overwritten in place, with the pointwise
    product (`ops/pointwise_cuda.py`) and the lift kernel (`ops/crt_cuda.py`),
    one launch each a polymul, inside; `chain_time` times it."""
    from concrete_ntt_tpu_torch.ops import crt_cuda, pointwise_cuda
    from concrete_ntt_tpu_torch.utils import profiling

    plan = native64.Plan32.try_new(1 << 14, device="cuda")
    ops = tuple(_u32(gen, (8, 1 << 14), cuda_device) for _ in range(4))

    def step(c):
        return (*plan.negacyclic_polymul(c[:2], c[2:]), c[0], c[1])

    before = crt_cuda.LAUNCHES["lift_u64_from5"], pointwise_cuda.LAUNCHES["pointwise_mont32"]
    step(ops)
    assert crt_cuda.LAUNCHES["lift_u64_from5"] == before[0] + 1
    assert pointwise_cuda.LAUNCHES["pointwise_mont32"] == before[1] + 1
    graph, out = profiling.capture(step, ops, 2)
    for fresh in (False, True):
        if fresh:
            for t in ops:
                t.copy_(_u32(gen, tuple(t.shape), cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(out, step(step(ops))):
            _same(got, want)
    assert profiling.chain_time(step, ops, length=4, reps=2) > 0


def test_chain_time_raises_on_a_host_sync(cuda_device):
    """A step that synchronises with the host cannot be captured:
    `chain_time` raises and names it, and the card works on after it."""
    from concrete_ntt_tpu_torch.utils import profiling

    def step(c):
        return (c[0] + c[0].sum().item(),)  # .item() waits for the device

    with pytest.raises(RuntimeError, match="cannot be captured in a CUDA graph"):
        profiling.chain_time(step, (torch.ones(64, device=cuda_device),), length=2, reps=1)
    assert torch.ones(3, device=cuda_device).sum().item() == 3
