"""The port's sharded four-steps (`concrete_ntt_tpu_torch.parallel`:
`fourstep_mxu`, `fourstep`, `_dist`, `dryrun`) in a world of four gloo ranks
on the CPU, against the JAX package's sharded functions on the conftest's
8-device CPU mesh (the same mesh shapes; the JAX functions jitted, through
their plain path as tests/test_parallel.py runs them) and against the port's
single-device plans.

One world runs every case (`_rank_cases`, started once a module by the
`world` fixture through `_dist.spawn`, rendezvous through a FileStore) and
hands back each rank's results; the tests read them. The rank processes
import no JAX. Inputs from numpy seeds; tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from concrete_ntt_tpu_torch import prime32, prime64
from concrete_ntt_tpu_torch.ops.u32 import np_u64_to_limbs
from concrete_ntt_tpu_torch.parallel import _dist
from concrete_ntt_tpu_torch.tables import GOLDILOCKS, PRIMES32, PRIMES52

WORLD = 4
N_MXU, B_MXU = 4096, 4
N_STAGE, B_STAGE = 1024, 4
REGIMES = {"lt30": 1073479681, "lt31": 2147352577, "generic": 4293918721}
# (mesh shape, dim names) of the GEMM four-steps: (dp, sp) with sp in {2, 4}
MXU_MESHES = {2: (2, 2), 4: (1, 4)}
MXU64_PRIMES = {"goldilocks": GOLDILOCKS, "p50": PRIMES52[0]}
# (split_axis, concat_axis, shape) of every exchange the modules make:
# fourstep_mxu (2, 1) on [b, rows, cols] and on stacked limb pairs, the
# stage four-step (1, 2) and (2, 1), the channel sections (3, 2) on
# [k, b, rows, cols] and on stacked limb pairs
EXCHANGES = ((2, 1, (3, 8, 16)), (2, 1, (3, 8, 16, 2)), (1, 2, (2, 16, 4)),
             (3, 2, (2, 3, 4, 8)), (3, 2, (2, 3, 4, 8, 2)))


def _x32(p, b, n, seed=1):
    return np.random.default_rng(seed).integers(0, p, (b, n), dtype=np.uint64).astype(np.uint32)


def _x64(p, b, n, seed=2):
    return np_u64_to_limbs(np.random.default_rng(seed).integers(0, p, (b, n), dtype=np.uint64))


def _exchange_input(rank, shape, seed=5):
    """Rank `rank`'s uint32 input to an exchange, with the top bit set."""
    v = np.random.default_rng(seed + rank).integers(0, 1 << 31, shape, dtype=np.uint32)
    return v | np.uint32(1 << 31)


def _rank_cases(rank, world):
    """Every case on one rank; the results as numpy arrays."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from concrete_ntt_tpu_torch.parallel import dryrun, fourstep, fourstep_mxu

    out = {}
    cpu = dict(device="cpu")
    for sp, shape in MXU_MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("dp", "sp"))
        plan = prime32.Plan.new(N_MXU, PRIMES32[0], **cpu)
        fwd, inv, to_dist, from_dist = fourstep_mxu.make_sharded_prime32_mxu(
            plan, mesh, axis="sp", batch_axis="dp", **cpu)
        x = torch.from_numpy(_x32(plan.p, B_MXU, N_MXU))
        f = fwd(to_dist(x))
        out["mxu32", sp] = tuple(from_dist(t).numpy() for t in (f, inv(f)))
        for name in ("lt31", "generic"):  # the channel-grid pass in the other regimes
            plan = prime32.Plan.new(N_MXU, REGIMES[name], **cpu)
            fwd, inv, to_dist, from_dist = fourstep_mxu.make_sharded_prime32_mxu(
                plan, mesh, axis="sp", batch_axis="dp", **cpu)
            f = fwd(to_dist(torch.from_numpy(_x32(plan.p, B_MXU, N_MXU))))
            out["mxu32", name, sp] = tuple(from_dist(t).numpy() for t in (f, inv(f)))
        for name, p in MXU64_PRIMES.items():
            if name == "p50" and sp == 4:
                continue
            plan = prime64.Plan.new(N_MXU, p, **cpu)
            fwd, inv, to_dist, from_dist = fourstep_mxu.make_sharded_prime64_mxu(
                plan, mesh, axis="sp", batch_axis="dp", **cpu)
            x = torch.from_numpy(_x64(p, B_MXU, N_MXU))
            f = fwd(to_dist(x))
            want = torch.from_numpy(prime64.Plan.new(N_MXU, p, **cpu).fwd(x).numpy())
            out["mxu64", name, sp] = tuple(from_dist(t).numpy()
                                           for t in (f, inv(to_dist(want, ntt=True)), inv(f)))
    for d in (2, 4):  # a dim the transform does not use replicates it
        mesh = init_device_mesh("cpu", (WORLD // d, d), mesh_dim_names=("rep", "x"))
        for name, p in REGIMES.items():
            plan = prime32.Plan.new(N_STAGE, p, **cpu)
            fwd, inv, to_dist, from_dist = fourstep.make_sharded_prime32(plan, mesh, **cpu)
            f = fwd(to_dist(torch.from_numpy(_x32(p, B_STAGE, N_STAGE))))
            out["stage", name, d] = tuple(from_dist(t).numpy() for t in (f, inv(f)))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("dp", "sp"))
    fwd, inv, to_dist, from_dist = fourstep.make_sharded_prime32(
        prime32.Plan.new(N_STAGE, PRIMES32[0], **cpu), mesh, axis="sp", batch_axis="dp", **cpu)
    f = fwd(to_dist(torch.from_numpy(_x32(PRIMES32[0], B_STAGE, N_STAGE))))
    out["stage dp"] = tuple(from_dist(t).numpy() for t in (f, inv(f)))
    for s, shape in ((2, (2, 2)), (4, (1, 4))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("dp", "sp"))
        for split, concat, shp in EXCHANGES:
            x = torch.from_numpy(_exchange_input(rank, shp))
            out["a2a", s, split, concat, shp] = _dist.all_to_all_tiled(
                mesh, x, "sp", split, concat).numpy()
    # validation: a dim that does not divide n1 / n2, a size too small to
    # shard, and no card without device="cpu"
    sub = DeviceMesh("cpu", [0, 1, 2], mesh_dim_names=("sp",))
    errors = {}
    if sub.get_coordinate() is not None:
        for key, call in (
            ("mxu32", lambda: fourstep_mxu.make_sharded_prime32_mxu(
                prime32.Plan.new(N_MXU, PRIMES32[0], **cpu), sub, **cpu)),
            ("mxu64", lambda: fourstep_mxu.make_sharded_prime64_mxu(
                prime64.Plan.new(N_MXU, GOLDILOCKS, **cpu), sub, **cpu)),
        ):
            try:
                call()
            except ValueError as e:
                errors[key] = str(e)
    mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
    for key, call in (
        ("tiny", lambda: fourstep.make_sharded_prime32(
            prime32.Plan.new(8, PRIMES32[0], **cpu), mesh4, **cpu)),
        ("no card", lambda: fourstep_mxu.make_sharded_prime32_mxu(
            prime32.Plan.new(N_MXU, PRIMES32[0], **cpu), mesh4, axis="x")),
    ):
        try:
            call()
        except (ValueError, RuntimeError) as e:
            errors[key] = f"{type(e).__name__}: {e}"
    out["errors"] = errors
    dryrun.dryrun(init_device_mesh("cpu", (1, 2, 2), mesh_dim_names=("dp", "ch", "sp")), **cpu)
    out["dryrun"] = True
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _dist.spawn(_rank_cases, WORLD, str(tmp_path_factory.mktemp("world") / "store"),
                       timeout=240)


def _jax_mesh(shape, names):
    import jax

    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(shape))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's sharded functions on the same inputs and mesh
    shapes, each jitted (their plain path on the CPU)."""
    import jax
    import jax.numpy as jnp

    from concrete_ntt_tpu import prime32 as jp32
    from concrete_ntt_tpu import prime64 as jp64
    from concrete_ntt_tpu.parallel.fourstep import make_sharded_prime32
    from concrete_ntt_tpu.parallel.fourstep_mxu import (
        make_sharded_prime32_mxu,
        make_sharded_prime64_mxu,
    )

    refs = {}
    for sp, shape in MXU_MESHES.items():
        mesh = _jax_mesh(shape, ("dp", "sp"))
        fwd, inv, to_dist, from_dist = make_sharded_prime32_mxu(
            jp32.Plan.new(N_MXU, PRIMES32[0]), mesh, axis="sp", batch_axis="dp")
        fwd, inv = jax.jit(fwd), jax.jit(inv)
        f = fwd(to_dist(jnp.asarray(_x32(PRIMES32[0], B_MXU, N_MXU))))
        refs["mxu32", sp] = tuple(np.asarray(from_dist(t)) for t in (f, inv(f)))
        fwd, inv, to_dist, from_dist = make_sharded_prime64_mxu(
            jp64.Plan.new(N_MXU, GOLDILOCKS), mesh, axis="sp", batch_axis="dp")
        fwd, inv = jax.jit(fwd), jax.jit(inv)
        f = fwd(to_dist(jnp.asarray(_x64(GOLDILOCKS, B_MXU, N_MXU))))
        refs["mxu64", "goldilocks", sp] = tuple(np.asarray(from_dist(t)) for t in (f, inv(f)))
    fwd, inv = make_sharded_prime32(jp32.Plan.new(N_STAGE, REGIMES["lt30"]),
                                    _jax_mesh((4,), ("x",)))
    f = np.asarray(fwd(_x32(REGIMES["lt30"], B_STAGE, N_STAGE)))
    refs["stage", "lt30", 4] = (f, np.asarray(inv(jnp.asarray(f))))
    return refs


@pytest.mark.parametrize("sp", sorted(MXU_MESHES))
def test_fourstep_mxu32_matches_jax(world, jax_refs, sp):
    """make_sharded_prime32_mxu at (dp, sp) = (4 / sp, sp): fwd and the round
    trip == the JAX sharded function's == the single-device plan's, on every
    rank."""
    plan = prime32.Plan.new(N_MXU, PRIMES32[0], device="cpu")
    x = torch.from_numpy(_x32(plan.p, B_MXU, N_MXU))
    want = plan.fwd(x).numpy()
    np.testing.assert_array_equal(jax_refs["mxu32", sp][0], want)
    for out in world:
        f, back = out["mxu32", sp]
        np.testing.assert_array_equal(f, want)
        np.testing.assert_array_equal(back, jax_refs["mxu32", sp][1])
        np.testing.assert_array_equal(back, plan.inv(plan.fwd(x)).numpy())


@pytest.mark.parametrize("sp", sorted(MXU_MESHES))
@pytest.mark.parametrize("regime", ["lt31", "generic"])
def test_fourstep_mxu32_regimes_match_single_device(world, regime, sp):
    """make_sharded_prime32_mxu in the lt31 and generic regimes (five digit
    planes near 2^32: K3's channel grid never takes its 128 x 64 tile
    there): fwd and the round trip == the single-device plan's."""
    plan = prime32.Plan.new(N_MXU, REGIMES[regime], device="cpu")
    x = torch.from_numpy(_x32(plan.p, B_MXU, N_MXU))
    for out in world:
        f, back = out["mxu32", regime, sp]
        np.testing.assert_array_equal(f, plan.fwd(x).numpy())
        np.testing.assert_array_equal(back, plan.inv(plan.fwd(x)).numpy())


@pytest.mark.parametrize("name,sp", [("goldilocks", 2), ("goldilocks", 4), ("p50", 2)])
def test_fourstep_mxu64_matches_jax(world, jax_refs, name, sp):
    """make_sharded_prime64_mxu on limb pairs: fwd, inv of the whole NTT
    (given as NTT-domain shards) and the round trip == the single-device
    prime64 plan; Goldilocks also == the JAX sharded function."""
    p = MXU64_PRIMES[name]
    plan = prime64.Plan.new(N_MXU, p, device="cpu")
    x = torch.from_numpy(_x64(p, B_MXU, N_MXU))
    want = plan.fwd(x)
    for out in world:
        f, back, rt = out["mxu64", name, sp]
        np.testing.assert_array_equal(f, want.numpy())
        np.testing.assert_array_equal(back, plan.inv(want).numpy())
        np.testing.assert_array_equal(rt, back)
        if ("mxu64", name, sp) in jax_refs:
            np.testing.assert_array_equal(f, jax_refs["mxu64", name, sp][0])
            np.testing.assert_array_equal(rt, jax_refs["mxu64", name, sp][1])


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_stage_fourstep_matches_single_device(world, jax_refs, regime, d):
    """make_sharded_prime32 (the stage four-step) in the three butterfly
    regimes over d ranks == prime32.Plan's fwd and inv; lt30 at d = 4 also ==
    the JAX sharded function."""
    p = REGIMES[regime]
    plan = prime32.Plan.new(N_STAGE, p, device="cpu")
    x = torch.from_numpy(_x32(p, B_STAGE, N_STAGE))
    want = plan.fwd(x).numpy()
    for out in world:
        f, back = out["stage", regime, d]
        np.testing.assert_array_equal(f, want)
        np.testing.assert_array_equal(back, plan.inv(torch.from_numpy(want)).numpy())
        if ("stage", regime, d) in jax_refs:
            np.testing.assert_array_equal(f, jax_refs["stage", regime, d][0])
            np.testing.assert_array_equal(back, jax_refs["stage", regime, d][1])


def test_stage_fourstep_dp_batch(world):
    """The stage four-step with the batch over dp and the transform over sp:
    fwd == the plan's, inv(fwd(x)) == n·x mod p."""
    p = PRIMES32[0]
    x = _x32(p, B_STAGE, N_STAGE)
    want = prime32.Plan.new(N_STAGE, p, device="cpu").fwd(torch.from_numpy(x)).numpy()
    for out in world:
        f, back = out["stage dp"]
        np.testing.assert_array_equal(f, want)
        np.testing.assert_array_equal(back, (x.astype(np.uint64) * N_STAGE % p).astype(np.uint32))


@pytest.mark.parametrize("split,concat,shape", EXCHANGES)
@pytest.mark.parametrize("s", [2, 4])
def test_all_to_all_tiled_matches_model(world, s, split, concat, shape):
    """`_dist.all_to_all_tiled` == a numpy model of JAX's tiled all-to-all:
    rank q receives chunk q of every rank's split axis, concatenated on the
    concat axis in rank order; uint32 with the top bit set crosses intact."""
    for rank, out in enumerate(world):
        q, base = rank % s, rank - rank % s  # its position and its group's first rank
        model = np.concatenate(
            [np.split(_exchange_input(base + r, shape), s, axis=split)[q] for r in range(s)],
            axis=concat)
        got = out["a2a", s, split, concat, shape]
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, model)


def test_validation_errors(world):
    """A mesh dim that does not divide n1 and n2, n too small to shard over
    the dim (as tests/test_parallel.py:101), and the card default without a
    card, raise."""
    errors = [out["errors"] for out in world]
    for e in errors[:3]:
        assert "must divide n1=64 and n2=64" in e["mxu32"] and "must divide" in e["mxu64"]
    assert "mxu32" not in errors[3]  # rank 3 is not in the three-rank mesh
    for e in errors:
        assert e["tiny"] == "ValueError: n=8 too small to shard over 4 devices"
        if not torch.cuda.is_available():
            assert e["no card"].startswith("RuntimeError") and 'device="cpu"' in e["no card"]


def test_dryrun_runs_on_every_rank(world):
    """`parallel.dryrun` (all four sharded paths, each held against the
    single-device plan) at (dp, ch, sp) = (1, 2, 2)."""
    assert all(out["dryrun"] for out in world)
