"""The port's channel-sharded native plans (`parallel/channels.py`:
`ChannelShardedNative`, `ChannelShardedNative52`) in a world of four gloo
ranks on the CPU, against the JAX package's classes on the conftest's
8-device CPU mesh with the same mesh shapes (tests/test_channels.py's
shapes, n = 4096), against the port's single-device plans, and the
collective count (tests/test_channels.py::test_collective_count_is_minimal:
three all-to-alls a polymul and the gather before the lift).

One world runs every case (`_rank_cases`, started once a module by the
`world` fixture); each JAX reference is computed once a module. Inputs from
numpy seeds; tolerance: exact equality.
"""

import types

import numpy as np
import pytest
import torch

from concrete_ntt_tpu_torch import native32, native64, native128, prime64
from concrete_ntt_tpu_torch.ops.u32 import np_u64_to_limbs
from concrete_ntt_tpu_torch.parallel import _dist
from concrete_ntt_tpu_torch.tables import PRIMES52
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as _lp

WORLD = 4
N = 4096
# name -> (port plan family, tier, mesh shape over (dp, ch, sp), batch, ranks in the mesh)
CASES = {
    "native128 dp1-ch2-sp2": (native128, "Plan32", (1, 2, 2), 4),
    "native128 dp2-ch2": (native128, "Plan32", (2, 2, 1), 2),
    "native64 dp2-sp2": (native64, "Plan32", (2, 1, 2), 2),
    "plan52 ch3": (native64, "Plan52", (1, 3, 1), 2),
    "plan52 dp2-sp2": (native64, "Plan52", (2, 1, 2), 2),
    "native32-plan52 dp2-ch2": (native32, "Plan52", (2, 2, 1), 2),
}
JAX_CASES = ("native128 dp1-ch2-sp2", "native128 dp2-ch2", "plan52 ch3", "plan52 dp2-sp2")
NAMES = ("dp", "ch", "sp")
# ChannelShardedNative52's two local routes, on plan-like prime sets at
# (dp, ch, sp) = (1, 1, 2): Plan52's primes share their plane counts (one K6
# launch a pass: "grid"); a 50-bit with a 40-bit prime (7 / 7 and 5 / 6 digit
# and operand planes) does not ("per-channel")
ROUTE52 = {"grid": tuple(PRIMES52[:2]),
           "per-channel": (PRIMES52[0], _lp(1 << 16, 1, 1 << 39, 1 << 40))}


def _operands(name):
    module, tier, _, b = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    if module is native128:
        return tuple(rng.integers(0, 1 << 32, (b, N, 4), dtype=np.uint32) for _ in range(2))
    if module is native32:
        return tuple(rng.integers(0, 1 << 32, (b, N), dtype=np.uint32) for _ in range(2))
    return tuple(rng.integers(0, 1 << 64, (b, N), dtype=np.uint64) for _ in range(2))


def _as_port(v):
    return v if v.dtype == np.uint64 else torch.from_numpy(v)


def _mesh(shape):
    """A DeviceMesh over the first prod(shape) ranks, and whether this rank
    is in it."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    mesh = DeviceMesh("cpu", ranks, mesh_dim_names=NAMES)
    return mesh, mesh.get_coordinate() is not None


def _route52_operands():
    rng = np.random.default_rng(52)
    return tuple(rng.integers(0, 1 << 64, (2, N), dtype=np.uint64) for _ in range(2))


def _route52_residues(sharded) -> np.ndarray:
    """lhs·rhs mod each local prime through the class's local sections (the
    passes, exchanges and pointwise product of its route; no lift),
    gathered whole: [k, b, n] uint64."""
    lhs, rhs = (sharded._shard(tuple(torch.from_numpy(np_u64_to_limbs(v)).unbind(-1)))
                for v in _route52_operands())
    res = sharded._inv_local(sharded._pointwise(sharded._fwd_local(lhs),
                                                sharded._fwd_local(rhs)))
    res = _dist.all_gather(sharded.mesh, res.contiguous(), (sharded.sp, 3)).numpy()
    res = res.reshape(*res.shape[:2], N, 2).astype(np.uint64)
    return res[..., 0] | (res[..., 1] << np.uint64(32))


def _rank_cases(rank, world):
    """Every case on one rank; results as numpy arrays (None where the rank
    is not in the case's mesh)."""
    from concrete_ntt_tpu_torch.parallel import channels

    out, calls = {}, {}
    for name, (module, tier, shape, _) in CASES.items():
        mesh, member = _mesh(shape)
        if not member:
            out[name] = None
            continue
        plan = getattr(module, tier).try_new(N, device="cpu")
        cls = channels.ChannelShardedNative52 if tier == "Plan52" else channels.ChannelShardedNative
        sharded = cls(plan, mesh, ch_axis="ch", batch_axis="dp", sp_axis="sp", device="cpu")
        lhs, rhs = _operands(name)
        _dist.reset_call_counts()
        got = sharded.negacyclic_polymul(_as_port(lhs), _as_port(rhs))
        calls[name] = dict(_dist.CALLS)
        out[name] = got if isinstance(got, np.ndarray) else got.numpy()
        if tier == "Plan52":
            out[name, "route"] = sharded.route
    mesh, member = _mesh((1, 1, 2))
    for route, primes in ROUTE52.items():
        if member:
            plan = types.SimpleNamespace(n=N, primes=primes, tier="plan52", width=64)
            sharded = channels.ChannelShardedNative52(plan, mesh, sp_axis="sp", device="cpu")
            out["route52", route] = (sharded.route, _route52_residues(sharded))
    errors = {}
    mesh, _ = _mesh((1, 2, 2))
    sub, member = _mesh((1, 1, 3))
    for key, make, m in (
        ("divide", lambda: native64.Plan32.try_new(N, device="cpu"), mesh),  # 5 channels, ch=2
        ("tier", lambda: native64.Plan52.try_new(N, device="cpu"), mesh),
        ("tier52", lambda: native64.Plan32.try_new(N, device="cpu"), mesh),
        ("sp", lambda: native128.Plan32.try_new(N, device="cpu"), sub),
        ("no card", lambda: native128.Plan32.try_new(N, device="cpu"), mesh),
    ):
        if key == "sp" and not member:
            continue
        cls = channels.ChannelShardedNative52 if key == "tier52" else channels.ChannelShardedNative
        kw = {} if key == "no card" else {"device": "cpu"}
        try:
            cls(make(), m, ch_axis="ch", sp_axis="sp", **kw)
        except (ValueError, RuntimeError) as e:
            errors[key] = f"{type(e).__name__}: {e}"
    return out, calls, errors


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _dist.spawn(_rank_cases, WORLD, str(tmp_path_factory.mktemp("world") / "store"),
                       timeout=240)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's ChannelShardedNative / ChannelShardedNative52 on the
    same operands and mesh shapes."""
    import jax

    from concrete_ntt_tpu import native64 as jn64
    from concrete_ntt_tpu import native128 as jn128
    from concrete_ntt_tpu.parallel.channels import ChannelShardedNative, ChannelShardedNative52

    refs = {}
    for name in JAX_CASES:
        module, tier, shape, _ = CASES[name]
        jmodule = jn128 if module is native128 else jn64
        devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
        mesh = jax.sharding.Mesh(devs, NAMES)
        cls = ChannelShardedNative52 if tier == "Plan52" else ChannelShardedNative
        sharded = cls(getattr(jmodule, tier).try_new(N), mesh, ch_axis="ch", batch_axis="dp",
                      sp_axis="sp")
        refs[name] = np.asarray(sharded.negacyclic_polymul(*_operands(name)))
    return refs


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_polymul_matches_single_device(world, name):
    """Every rank of the case's mesh returns the whole product, == the
    port's single-device plan on the same operands."""
    module, tier, shape, _ = CASES[name]
    plan = getattr(module, tier).try_new(N, device="cpu")
    want = plan.negacyclic_polymul(*map(_as_port, _operands(name)))
    want = want if isinstance(want, np.ndarray) else want.numpy()
    outs = [out[name] for out, _, _ in world]
    assert sum(o is not None for o in outs) == int(np.prod(shape))
    for got in outs:
        if got is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_polymul_matches_jax(world, jax_refs, name):
    """== the JAX package's sharded class on the mesh of the same shape."""
    for out, _, _ in world:
        if out[name] is not None:
            np.testing.assert_array_equal(out[name], jax_refs[name])


def test_plan52_routes_match_single_channel_plans(world):
    """ChannelShardedNative52 decides its route once from its primes: "grid"
    for Plan52's (every case of CASES) and for two of its primes,
    "per-channel" for a 50-bit with a 40-bit prime; on both, each channel's
    residues of the product == the single-device prime64 plan's polymul of
    the operands' residues."""
    for out, _, _ in world:
        for name, (module, tier, _, _) in CASES.items():
            if tier == "Plan52" and out[name] is not None:
                assert out[name, "route"] == "grid"
    lhs, rhs = _route52_operands()
    for route, primes in ROUTE52.items():
        got = [out["route52", route] for out, _, _ in world if ("route52", route) in out]
        assert len(got) == 2
        for r, res in got:
            assert r == route
            for k, p in enumerate(primes):
                want = prime64.Plan.new(N, p, device="cpu").negacyclic_polymul(
                    lhs % np.uint64(p), rhs % np.uint64(p))
                np.testing.assert_array_equal(res[k], want, err_msg=f"{route} p={p}")


def test_collective_count_is_minimal(world):
    """A polymul at (dp, ch, sp) = (1, 2, 2) issues three all-to-alls (one a
    transform) and two all-gathers (channels, columns) before the lift, and
    nothing else, as the JAX package's compiled program; with dp = 2 and no
    sp, no all-to-all, the channels' gather and the gather of the lifted
    rows."""
    for _, calls, _ in world:
        assert calls["native128 dp1-ch2-sp2"] == {"all_to_all": 3, "all_gather": 2}
        assert calls["native128 dp2-ch2"] == {"all_to_all": 0, "all_gather": 2}


def test_channel_sharded_validation(world):
    """As tests/test_channels.py:81-89: channels that do not divide over ch,
    the wrong tier for either class; and an sp that does not divide n1, n2,
    and the card default without a card."""
    for rank, (_, _, errors) in enumerate(world):
        assert "channels must divide over ch=2" in errors["divide"]
        assert "plan32-tier" in errors["tier"]
        assert "plan52" in errors["tier52"]
        if rank < 3:
            assert "sp=3 must divide n1=64 and n2=64" in errors["sp"]
        if not torch.cuda.is_available():
            assert errors["no card"].startswith("RuntimeError")
