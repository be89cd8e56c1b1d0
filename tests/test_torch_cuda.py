"""Card tests of the port: K1a / K1b against their plain torch twins, and
the native64 Plan32 polymul through the kernels against the CPU plain path.

Every test here is marked `cuda` and skips without a CUDA GPU. The file
imports only the port (no JAX), so it runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest` skips tests/conftest.py, which configures JAX.) Tolerance:
exact equality.
"""

import numpy as np
import pytest
import torch

from concrete_ntt_tpu_torch import native64
from concrete_ntt_tpu_torch.ops import mxu32_cuda
from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    return np.random.default_rng(0x5EED)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _u32(gen, shape, device):
    return torch.from_numpy(gen.integers(0, 1 << 32, shape, dtype=np.uint32)).to(device)


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
    plan = native64.Plan32.try_new(n)
    lhs, rhs = ((_u32(gen, (b, n), "cpu"), _u32(gen, (b, n), "cpu")) for _ in range(2))
    mxu32_cuda.reset_launch_counts()
    got = plan.negacyclic_polymul(tuple(t.to(cuda_device) for t in lhs),
                                  tuple(t.to(cuda_device) for t in rhs))
    assert mxu32_cuda.LAUNCHES == {"fwd_wide_multi": 2, "inv_multi": 1}
    want = plan.negacyclic_polymul(lhs, rhs)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
