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
from concrete_ntt_tpu_torch import tables as ttab
from concrete_ntt_tpu_torch.ops import mxu32 as tmx
from concrete_ntt_tpu_torch.ops import mxu32_cuda as tcu

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
        assert ttab.native_channel_primes(5, n) == jtab.native_channel_primes(5, n)


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
        _assert_same(tcu._multi_tables(n, PRIMES, limbs, scales),
                     jpal._multi_tables(n, PRIMES, limbs, scales))


def test_import_leaves_jax_out():
    code = (
        "import sys, concrete_ntt_tpu_torch, concrete_ntt_tpu_torch.ops.mxu32_cuda; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert 'concrete_ntt_tpu' not in sys.modules, 'concrete_ntt_tpu imported'; "
        "assert 'triton' not in sys.modules, 'triton imported'"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
