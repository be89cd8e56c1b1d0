"""Port host tables vs the JAX package's, array for array, and the port's
import isolation (it must never load jax or concrete_ntt_tpu)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from concrete_ntt_tpu import tables as jtab
from concrete_ntt_tpu.ops import mxu32 as jmx
from concrete_ntt_tpu.ops import mxu32_pallas as jpal
from concrete_ntt_tpu.ops import mxu64 as jmx64
from concrete_ntt_tpu.ops import mxu64_pallas as jpal64
from concrete_ntt_tpu_torch import tables as ttab
from concrete_ntt_tpu_torch.ops import mxu32 as tmx
from concrete_ntt_tpu_torch.ops import mxu32_cuda as tcu
from concrete_ntt_tpu_torch.ops import mxu64 as tmx64
from concrete_ntt_tpu_torch.ops import mxu64_cuda as tcu64
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as _lp

PRIMES = jtab.NATIVE64_PRIMES
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scale(n, p):
    return pow(n, p - 2, p) * pow(2, 32, p) % p


def _assert_same(port, ref, path="tables"):
    """Recursive equality of dicts / tuples / arrays / scalars, dtype included
    for arrays."""
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


def test_prime_tables_match_jax():
    assert ttab.PRIMES32 == jtab.PRIMES32
    assert ttab.NATIVE64_PRIMES == jtab.NATIVE64_PRIMES
    assert ttab.primes32_ext() == jtab.primes32_ext()
    assert ttab.generate_ntt_primes(3, 30, 1 << 16) == jtab.generate_ntt_primes(3, 30, 1 << 16)
    for n in (1 << 10, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18):
        for k in (1, 2, 3, 5, 10):
            assert ttab.native_channel_primes(k, n) == jtab.native_channel_primes(k, n)


@pytest.mark.parametrize("name", ["NATIVE32_PRIMES", "NATIVE64_PRIMES", "NATIVE128_PRIMES",
                                  "NATIVE_BINARY32_PRIMES", "NATIVE_BINARY64_PRIMES",
                                  "NATIVE_BINARY128_PRIMES"])
def test_native_prime_selections_and_crt_constants_match_jax(name):
    primes = getattr(ttab, name)
    assert primes == getattr(jtab, name)
    port, ref = ttab.crt_constants(primes), jtab.crt_constants(primes)
    assert port == ref
    m = port["product"]
    assert all(mi * y % p == 1 and mi * p == m
               for mi, y, p in zip(port["big_m"], port["y"], primes))
    assert ttab.crt_constants(ttab.PRIMES52[:3]) == jtab.crt_constants(jtab.PRIMES52[:3])


@pytest.mark.parametrize("n", [1 << 11, 1 << 14])
def test_u128_tables_match_jax(n):
    """The four-limb column planes (16 operand digit planes) of a few of the
    ten channels, and the channel-grid tables of the native_binary128 set."""
    for p in (ttab.NATIVE128_PRIMES[0], ttab.NATIVE128_PRIMES[9]):
        _assert_same(tmx._wide_col_planes(n, p, 4), jmx._wide_col_planes(n, p, 4))
    primes = ttab.NATIVE_BINARY128_PRIMES
    ones = (1,) * len(primes)
    ref = jpal._multi_tables(n, primes, 4, ones)
    ref.pop("scalars")
    _assert_same(tcu._multi_tables(n, primes, 4, ones), ref)


@pytest.mark.parametrize("n", [1 << 11, 1 << 14])
@pytest.mark.parametrize("p", PRIMES)
def test_mxu_tables_match_jax(n, p):
    _assert_same(tmx._operators(n, p), jmx._operators(n, p), "operators")
    _assert_same(tmx._mxu_tables(n, p), jmx._mxu_tables(n, p))
    for limbs in (1, 2):
        _assert_same(tmx._wide_col_planes(n, p, limbs), jmx._wide_col_planes(n, p, limbs))
    s = _scale(n, p)
    _assert_same(tmx._scaled_ainv_planes(n, p, s), jmx._scaled_ainv_planes(n, p, s))


@pytest.mark.parametrize("n", [1 << 11, 1 << 14])
def test_multi_tables_match_jax(n):
    scales = tuple(_scale(n, p) for p in PRIMES)
    for limbs in (1, 2):
        ref = jpal._multi_tables(n, PRIMES, limbs, scales)
        # the kernels read the per-prime scalar record instead of the JAX
        # [C, 5] scalars: p, c32, c32_shoup and 2p must agree
        jscal = ref.pop("scalars")
        record = np.stack([tcu.scalar_record(p) for p in PRIMES])
        np.testing.assert_array_equal(record[:, [0, 1, 2, 5]], jscal[:, [0, 1, 2, 4]])
        _assert_same(tcu._multi_tables(n, PRIMES, limbs, scales), ref)


REGIMES64 = {
    "goldilocks": jtab.GOLDILOCKS,
    "p50": jtab.PRIMES52[0],
    "p63": _lp(1 << 15, 1, 1 << 62, 1 << 63),
    "p64": _lp(1 << 15, 1, 1 << 63, (1 << 64) - 1),
    "p62": _lp(1 << 16, 1, 1 << 61, 1 << 62),
}


def test_prime64_constants_match_jax():
    assert ttab.PRIMES52 == jtab.PRIMES52 and ttab.GOLDILOCKS == jtab.GOLDILOCKS


@pytest.mark.parametrize("regime", list(REGIMES64))
def test_mxu64_tables_match_jax(regime):
    """The C++-built operators and every array and scalar of the 64-bit
    table dict, in the five regime primes at n = 2048."""
    p, n = REGIMES64[regime], 2048
    _assert_same(tmx64._operators(n, p), jmx64._operators(n, p), "operators")
    _assert_same(tmx64._build_operators(n, p), jmx64._operators(n, p), "built operators")
    _assert_same(tmx64._tables(n, p), jmx64._tables(n, p))
    s = pow(n, p - 2, p) * pow(2, 64, p) % p
    _assert_same(tmx64._scaled_ainv_planes(n, p, s), jmx64._scaled_ainv_planes(n, p, s))


@pytest.mark.parametrize("n", [1 << 11, 1 << 14])
def test_multi_tables64_match_jax(n):
    primes = jtab.PRIMES52[:3]
    if n == 1 << 14:
        for p in primes:
            _assert_same(tmx64._tables(n, p), jmx64._tables(n, p))
    scales = tuple(pow(n, p - 2, p) * pow(2, 64, p) % p for p in primes)
    for sc in ((1,) * 3, scales):
        _assert_same(tmx64._multi_tables64(n, primes, sc), jpal64._multi_tables64(n, primes, sc))
    record = np.stack([tcu64.scalar_record(n, p) for p in primes])
    np.testing.assert_array_equal(record, jpal64._multi_tables64(n, primes, scales)["scalars"])


def test_import_leaves_jax_out():
    code = (
        "import sys, concrete_ntt_tpu_torch, concrete_ntt_tpu_torch.ops.mxu32_cuda, "
        "concrete_ntt_tpu_torch.ops.mxu64_cuda, concrete_ntt_tpu_torch.ops.stagesplit, "
        "concrete_ntt_tpu_torch.prime64; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert 'concrete_ntt_tpu' not in sys.modules, 'concrete_ntt_tpu imported'; "
        "assert 'triton' not in sys.modules, 'triton imported'"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
