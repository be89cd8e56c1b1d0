"""K1a / K1b of the port (ops/mxu32_cuda.py, ops/mxu32.py) vs the JAX package.

On the CPU the wrappers run their plain torch twins. These are held against
the JAX channel-grid Pallas kernels run in interpret mode (the fixture of
tests/test_pallas_interpret.py) and against the single-channel XLA engine;
the packed-plane layout the CUDA kernel reads is checked by a numpy dp4a
emulation; the kernels themselves run in tests/test_torch_cuda.py.
Tolerance: exact equality everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import mxu32 as jmx
from concrete_ntt_tpu.ops import mxu32_pallas as jpal
from concrete_ntt_tpu_torch.ops import cuda_build
from concrete_ntt_tpu_torch.ops import mxu32 as tmx
from concrete_ntt_tpu_torch.ops import mxu32_cuda as tcu
from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64

N_BIG = 1 << 14


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CONCRETE_NTT_TPU_PALLAS_INTERPRET", "1")


def _scale(n, p):
    return pow(n, p - 2, p) * pow(2, 32, p) % p


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


@pytest.mark.parametrize("b", [8, 5])
@pytest.mark.parametrize("case", ["fwd1", "fwd2", "inv", "inv_scaled"])
def test_multi_plain_matches_pallas_interpret(rng, interpret, case, b):
    if case.startswith("fwd"):
        limbs = tuple(_u32(rng, (b, N_BIG)) for _ in range(int(case[-1])))
        got = tcu.fwd_wide_multi(tuple(map(torch.from_numpy, limbs)), PRIMES)
        want = jpal.fwd_wide_multi(tuple(map(jnp.asarray, limbs)), PRIMES)
    else:
        x = _u32(rng, (len(PRIMES), b, N_BIG))
        scales = tuple(
            _scale(N_BIG, p) if case == "inv_scaled" else 1 for p in PRIMES
        )
        got = tcu.inv_multi(torch.from_numpy(x), PRIMES, scales)
        want = jpal.inv_multi(jnp.asarray(x), PRIMES, scales)
    assert got.dtype == torch.uint32 and got.shape == (len(PRIMES), b, N_BIG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _prime(n, lo, hi):
    return largest_prime_in_arithmetic_progression64(2 * n, 1, lo, hi)


@pytest.mark.parametrize(
    "p",
    [PRIMES[2], _prime(2048, 1 << 30, 1 << 31), _prime(2048, 1 << 31, (1 << 32) - 1)],
    ids=["lt30", "lt31", "generic"],
)
@pytest.mark.parametrize("case", ["fwd1", "fwd2", "inv", "inv_scaled"])
def test_single_channel_plain_matches_xla(rng, case, p):
    n = 2048
    if case.startswith("fwd"):
        limbs = tuple(_u32(rng, (3, n)) for _ in range(int(case[-1])))
        if len(limbs) == 1:
            got = tmx.fwd(torch.from_numpy(limbs[0]), n=n, p=p)
            want = jmx.fwd(jnp.asarray(limbs[0]), n=n, p=p)
        else:
            got = tmx.fwd_wide(tuple(map(torch.from_numpy, limbs)), n=n, p=p)
            want = jmx.fwd_wide(tuple(map(jnp.asarray, limbs)), n=n, p=p)
    else:
        x = _u32(rng, (3, n))
        s = _scale(n, p) if case == "inv_scaled" else 1
        got = tmx.inv(torch.from_numpy(x), n=n, p=p, scale=s)
        want = jmx.inv(jnp.asarray(x), n=n, p=p, scale=s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_limbs", [1, 2])
def test_packed_planes_dp4a_emulation(rng, n_limbs):
    """The packed plane words the kernel reads, contracted four digits per
    dp4a against (v ^ 0x80808080), equal the int8 digit-plane product."""
    n = 2048
    tabs = tcu._multi_tables(n, PRIMES, n_limbs, (1,) * len(PRIMES))
    planes = tabs["fwd"][0]  # [C, 4*L*n1, 4*n1]
    n1 = tabs["n1"]
    words = tcu.pack_planes(planes, n1)
    assert words.shape == (len(PRIMES), n_limbs * n1, 4 * n1) and words.dtype == np.int32
    x = _u32(rng, (7, n_limbs * n1))  # rows of limb-major operand values
    xb = (x ^ np.uint32(0x80808080)).view(np.int8).reshape(7, n_limbs * n1, 4)
    wb = words.view(np.int8).reshape(len(PRIMES), n_limbs * n1, 4 * n1, 4)
    dp4a = np.einsum("rke,ckoe->cro", xb.astype(np.int64), wb.astype(np.int64))
    digits = tmx._digit_cat(
        tuple(torch.from_numpy(x[:, l * n1:(l + 1) * n1].astype(np.int64)) for l in range(n_limbs))
    )
    for c in range(len(PRIMES)):
        ref = torch._int_mm(digits, torch.from_numpy(planes[c])).numpy()
        np.testing.assert_array_equal(dp4a[c], ref)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "_BUILD", str(tmp_path / "kernels"))
    monkeypatch.setattr(cuda_build, "_NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("mxu32_multi")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tcu._lib()
    assert not (tmp_path / "kernels").exists() or not any((tmp_path / "kernels").iterdir())


def test_wrappers_route_by_device_and_range(rng):
    x = torch.from_numpy(_u32(rng, (2, 2048)))
    with pytest.raises(ValueError, match="no route"):
        tcu.fwd_wide_multi((x.to("meta"),), PRIMES)
    with pytest.raises(ValueError, match="no route"):
        tcu.inv_multi(torch.stack([x] * len(PRIMES)).to("meta"), PRIMES, (1,) * len(PRIMES))
    with pytest.raises(TypeError):
        tcu.fwd_wide_multi((x.to(torch.int64),), PRIMES)
    small = torch.from_numpy(_u32(rng, (2, 1024)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcu.fwd_wide_multi((small,), PRIMES)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcu.fwd_wide_multi((x, x, x, x), PRIMES)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcu.fwd_wide_multi((x,), (4293918721,))
    before = dict(tcu.LAUNCHES)
    tcu.fwd_wide_multi((x,), PRIMES)
    assert tcu.LAUNCHES == before  # the CPU route launches nothing
