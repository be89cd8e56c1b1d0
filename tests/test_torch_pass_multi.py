"""The channel-grid GEMM passes of the sharded four-step on the CPU: K3's
`mxu32_cuda.pass_matmod_multi` and K6's `mxu64_cuda.pass_matmod64_multi`
(their plain twins here), the tile rules they launch with
(`mxu32_cuda.k3_multi_tile` = `k1_tile` on K3's grids, `mxu64_cuda.k6_tile`),
the operand layout rule (`mxu32_cuda.pass_layout`) and the route of
`parallel.channels.ChannelShardedNative52` (`channels.route52`).

Operands are laid out as the sharded routes lay them: the A pass reads the
value shard [b, n1, n2 / s] in place through a transposed view (one operand
for every channel), F the exchange's [C, b, n2, n1 / s], G [C, b, n1 / s, n2]
and A_inv the exchange's [C, b, n1, n2 / s], writing its transpose. Each
channel-grid result is held against the single-channel `pass_matmod_plain` /
`pass_matmod64_plain` on the same values made contiguous in numpy, and, at
n = 4096, against the JAX package's `pass_matmod` / `pass_matmod64` behind
`jnp.swapaxes` (Pallas in interpret mode, as tests/test_torch_mxu32.py runs
them). Inputs from numpy seeds; tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_ntt_tpu.ops import mxu32_pallas as jpal
from concrete_ntt_tpu.ops import mxu64_pallas as jpal64
from concrete_ntt_tpu_torch.ops import mxu32, mxu64
from concrete_ntt_tpu_torch.ops import mxu32_cuda as tcu
from concrete_ntt_tpu_torch.ops import mxu64_cuda as tcu64
from concrete_ntt_tpu_torch.parallel import channels
from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
from concrete_ntt_tpu_torch.tables import PRIMES52
from concrete_ntt_tpu_torch.utils.prime import largest_prime_in_arithmetic_progression64 as _lp

GENERIC = 4293918721  # five matrix digit planes
P40 = _lp(1 << 16, 1, 1 << 39, 1 << 40)  # five digit planes, six operand planes
# (which, operand limbs, with diagonal rows): every pass the routes make, and
# A / G canonical
K3_CASES = {"A-scaled": ("A", 1, True), "A-2limbs": ("A", 2, True), "A-4limbs": ("A", 4, True),
            "A-canonical": ("A", 1, False), "F": ("F", 1, False), "G-scaled": ("G", 1, True),
            "G-canonical": ("G", 1, False), "Ainv": ("Ainv", 1, False),
            "Ainv-scaled": ("Ainv", 1, False)}
K6_CASES = {"A-scaled": ("A", True), "A-canonical": ("A", False), "F": ("F", False),
            "G-scaled": ("G", True), "Ainv": ("Ainv", False), "Ainv-scaled": ("Ainv", False)}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CONCRETE_NTT_TPU_PALLAS_INTERPRET", "1")


def _route(rng, which: str, n: int, b: int, s: int, c: int, limbs: int, hi=1 << 32):
    """numpy limbs of one pass's operand as the sharded routes hold it, and
    the operand [C or 1, b, rows, K] contiguous: A the value shard [b, n1,
    n2 / s] (shared), F the exchange's [C, b, n2, n1 / s], G [C, b, n1 / s,
    n2], A_inv [C, b, n1, n2 / s]. `hi` bounds the values of F / A_inv's
    second limb (64-bit mid-pass values)."""
    n1, n2 = mxu32.four_step_factors(n)
    shape, swap = {"A": ((b, n1, n2 // s), True), "F": ((c, b, n2, n1 // s), True),
                   "G": ((c, b, n1 // s, n2), False), "Ainv": ((c, b, n1, n2 // s), True)}[which]
    held = [rng.integers(0, 1 << 32, shape, dtype=np.uint32) for _ in range(limbs)]
    if which in ("F", "Ainv") and limbs == 2:
        held[1] = rng.integers(0, hi, shape, dtype=np.uint32)
    dense = [np.ascontiguousarray(np.swapaxes(a, -1, -2) if swap else a) for a in held]
    return held, [a if a.ndim == 4 else a[None] for a in dense], swap


def _view(held: list, swap: bool, layout: str) -> tuple:
    """The pass operand as torch views: the route's transposed views, or the
    same values as contiguous tensors."""
    t = [torch.from_numpy(a) for a in held]
    if swap:
        t = [a.transpose(-1, -2) for a in t]
    return tuple(a.contiguous() if layout == "contiguous" else a for a in t)


@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("c", [1, 2, 3, 5])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_multi_plain_matches_per_channel(rng, case, c, layout):
    """K3's channel grid == per channel `pass_matmod_plain` on the operand
    made contiguous, stacked (transposed for A_inv's `transposed_out`), at
    n = 2048, s = 2, b = 2 over c channel primes."""
    which, limbs, scaled = K3_CASES[case]
    n, b, s = 2048, 2, 2
    primes = tuple(PRIMES[:c]) if c < 5 else tuple(PRIMES)
    held, dense, swap = _route(rng, which, n, b, s, c, limbs)
    rows = dense[0].shape[-2]
    n1, n2 = mxu32.four_step_factors(n)
    diag = tcu.multi_diag(n, primes, which, rows, rows, "cpu") if scaled else None
    scales = (tuple(pow(n, p - 2, p) * 3 % p for p in primes) if case == "Ainv-scaled"
              else None)
    out_t = which == "Ainv"
    got = tcu.pass_matmod_multi(_view(held, swap, layout), n=n, primes=primes, which=which,
                                diag=diag, scales=scales, transposed_out=out_t)
    want = []
    for ch, p in enumerate(primes):
        xc = tuple(torch.from_numpy(a[ch if a.shape[0] > 1 else 0]) for a in dense)
        dg = tuple(torch.from_numpy(t[rows:2 * rows]) for t in mxu32._mxu_tables(n, p)[
            {"A": "d", "G": "e"}[which]]) if scaled else ()
        o = tcu.pass_matmod_plain(xc if limbs > 1 else xc[0], n=n, p=p, which=which,
                                  diag_slices=dg, n_limbs=limbs,
                                  scale=scales[ch] if scales else 1).numpy()
        want.append(np.swapaxes(o, -1, -2) if out_t else o)
    assert got.dtype == torch.uint32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    assert got.shape[-1] == (rows if out_t else n1 if which == "A" else n2)


@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("c", [1, 2, 3, 5])
@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_multi_plain_matches_per_channel(rng, case, c, layout):
    """K6's channel grid on limb pairs == per channel `pass_matmod64_plain`
    on the pair made contiguous, stacked, at n = 2048, s = 2, b = 2 over c
    Plan52 primes (F / A_inv's operands below 2^50, mid-pass values)."""
    which, scaled = K6_CASES[case]
    n, b, s = 2048, 2, 2
    primes = tuple(PRIMES52[:c])
    held, dense, swap = _route(rng, which, n, b, s, c, 2, hi=1 << 18)
    rows = dense[0].shape[-2]
    diag = tcu64.multi_diag(n, primes, which, 0, rows, "cpu") if scaled else None
    scales = (tuple(pow(n, p - 2, p) * pow(2, 64, p) % p for p in primes)
              if case == "Ainv-scaled" else None)
    out_t = which == "Ainv"
    got = tcu64.pass_matmod64_multi(_view(held, swap, layout), n=n, primes=primes, which=which,
                                    diag=diag, scales=scales, transposed_out=out_t)
    for i in range(2):
        want = []
        for ch, p in enumerate(primes):
            xc = tuple(torch.from_numpy(a[ch if a.shape[0] > 1 else 0]) for a in dense)
            dg = tuple(torch.from_numpy(t[:rows]) for t in mxu64._tables(n, p)[
                {"A": "d", "G": "e"}[which]]) if scaled else ()
            o = tcu64.pass_matmod64_plain(xc, n=n, p=p, which=which, diag_slices=dg,
                                          scale=scales[ch] if scales else 1)[i].numpy()
            want.append(np.swapaxes(o, -1, -2) if out_t else o)
        np.testing.assert_array_equal(got[i].numpy(), np.stack(want))


@pytest.mark.parametrize("word", [32, 64])
def test_multi_matches_pallas_interpret(rng, interpret, word):
    """At n = 4096, s = 2, b = 2: K3's grid over two 30-bit primes (A with
    two limbs, F, G, A_inv scaled) and over one five-plane prime (A, F, G,
    A_inv), K6's over two Plan52 primes, == the JAX package's pass_matmod /
    pass_matmod64 channel by channel on the operand behind `jnp.swapaxes`
    (the route's transposes) and its output swapped back for A_inv."""
    n, b, s = 4096, 2, 2
    sets = ([tuple(PRIMES[:2]), (GENERIC,)] if word == 32 else [tuple(PRIMES52[:2])])
    for primes in sets:
        for which in ("A", "F", "G", "Ainv"):
            limbs = 2 if word == 64 or (which == "A" and len(primes) == 2) else 1
            held, _, swap = _route(rng, which, n, b, s, len(primes), limbs,
                                   hi=1 << 18 if word == 64 else 1 << 32)
            rows = held[0].shape[-1 if swap else -2]
            mod = tcu if word == 32 else tcu64
            diag = (mod.multi_diag(n, primes, which, rows, rows, "cpu")
                    if which in ("A", "G") else None)
            scales = (tuple(pow(n, p - 2, p) * 5 % p for p in primes) if which == "Ainv"
                      else None)
            x = _view(held, swap, "strided")
            kw = dict(n=n, primes=primes, which=which, diag=diag, scales=scales,
                      transposed_out=which == "Ainv")
            got = (tcu.pass_matmod_multi(x if limbs > 1 else x[0], **kw) if word == 32
                   else torch.stack(tcu64.pass_matmod64_multi(x, **kw)))
            for ch, p in enumerate(primes):
                xj = tuple(jnp.swapaxes(jnp.asarray(a[ch] if a.ndim == 4 else a), -1, -2)
                           if swap else jnp.asarray(a[ch]) for a in held)
                dg = tuple(jnp.asarray(t) for t in diag[ch].numpy()) if diag is not None else ()
                sc = scales[ch] if scales else 1
                if word == 32:
                    want = jpal.pass_matmod(xj if limbs > 1 else xj[0], n=n, p=p, which=which,
                                            diag_slices=dg, n_limbs=limbs, scale=sc)
                    want = (np.asarray(want),)
                    mine = (got[ch].numpy(),)
                else:
                    want = tuple(np.asarray(a) for a in jpal64.pass_matmod64(
                        xj, n=n, p=p, which=which, mont_slices=dg, scale=sc))
                    mine = tuple(got[i, ch].numpy() for i in range(2))
                for g, w in zip(mine, want):
                    np.testing.assert_array_equal(g, np.swapaxes(w, -1, -2)
                                                  if which == "Ainv" else w,
                                                  err_msg=f"{word} {primes} {which}")


def _route_tiles(n: int, b: int, s: int, c: int, limbs: int, n_d: int = 4) -> tuple:
    """`k3_multi_tile` of the four passes of a rank's transform pair at
    (n, b, s) over c channels: A (limbs), F, G, A_inv."""
    n1, n2 = mxu32.four_step_factors(n)
    return (tcu.k3_multi_tile(b, n2 // s, n1, c, limbs * n1 // 32, True, n_d),
            tcu.k3_multi_tile(b, n1 // s, n2, c, n2 // 32, False, n_d),
            tcu.k3_multi_tile(b, n1 // s, n2, c, n2 // 32, True, n_d),
            tcu.k3_multi_tile(b, n2 // s, n1, c, n1 // 32, False, n_d))


def test_k3_multi_tile_at_the_route_shapes():
    """`k1_tile` on K3's grids (the product plan's rule), pinned at the sharded routes'
    shapes: native128 (2^16, 8) at (dp, ch, sp) = (1, 2, 2), 5 channels,
    four-limb A: K1's ring everywhere (64 x 16 would be 1280 blocks, the
    contraction is 8-32 stages, 128 x 64 160 blocks); its world of one (10
    channels, s = 1) the same; native64 (2^14, 8) through one channel at
    (2, 1, 2) and in a world of one: 64 x 16 (32 and 64 blocks instead of 8
    and 16). K1's tile holding four stages whole at (2^14, 16, s = 1, C =
    2); 128 x 64 for the canonical passes at (4096, 16, s = 1, C = 10); no
    128 x 64 tile with five digit planes (N would be 320)."""
    assert _route_tiles(1 << 16, 8, 2, 5, 4) == (0, 0, 0, 0)
    assert _route_tiles(1 << 16, 8, 1, 10, 4) == (0, 0, 0, 0)
    assert _route_tiles(1 << 14, 4, 2, 1, 1) == (1, 1, 1, 1)
    assert _route_tiles(1 << 14, 8, 1, 1, 1) == (1, 1, 1, 1)
    assert _route_tiles(4096, 16, 4, 1, 1) == (1, 1, 1, 1)  # four ranks of a 4096 transform
    assert _route_tiles(1 << 14, 16, 1, 2, 1) == (2, 2, 2, 2)
    assert _route_tiles(4096, 16, 1, 10, 1) == (0, 3, 0, 3)
    assert _route_tiles(4096, 16, 1, 10, 1, n_d=5) == (0, 0, 0, 0)
    assert _route_tiles(1 << 17, 16, 2, 1, 1) == (0, 3, 0, 3)
    assert _route_tiles(1 << 17, 16, 2, 1, 1, n_d=5) == (0, 0, 0, 0)


def test_k3_multi_tile_fits_every_route_shape():
    """At every shape the routes reach (n = 2^11 .. 2^17, s in {1, 2, 4},
    1-5 and 10 channels, B in {1, 2, 3, 4, 8, 16}, 1, 2 and 4 limbs, four
    and five digit planes) the chosen tile fits: whole output tiles, 128 x
    64 only for canonical passes with four digit planes, and the route's
    operand views pass the layout rule (rows a polynomial a multiple of 4,
    strides multiples of 4)."""
    seen = set()
    for log_n in range(11, 18):
        n = 1 << log_n
        n1, n2 = mxu32.four_step_factors(n)
        for s in (1, 2, 4):
            for c in (1, 2, 3, 4, 5, 10):
                for b in (1, 2, 3, 4, 8, 16):
                    for limbs in (1, 2, 4):
                        for n_d in (4, 5):
                            tiles = _route_tiles(n, b, s, c, limbs, n_d)
                            for t, o, scaled in zip(tiles, (n1, n2, n2, n1),
                                                    (True, False, True, False)):
                                assert o % tcu.TILES[t][1] == 0, (n, s, c, b, t)
                                assert t != 3 or (n_d == 4 and not scaled)
                                seen.add(t)
            x = torch.zeros((2, n1, n2 // s), dtype=torch.uint32)
            assert tcu.pass_layout((x.transpose(1, 2),), 1)[1] == (0, n1 * n2 // s, 1, n2 // s)
            y = torch.zeros((3, 2, n2, n1 // s), dtype=torch.uint32)
            assert tcu.pass_layout((y.transpose(2, 3),), 3)[1] == (
                2 * n1 * n2 // s, n1 * n2 // s, 1, n1 // s)
    assert seen == {0, 1, 2, 3}


def test_k6_tile_at_the_route_shapes():
    """`k6_tile`, the sweep's rule: 64 rows where a grid of 128-row blocks
    would be at most 198 (one and a half an SM). Plan52 (2^14, 8) at
    (2, 1, 2), 3 channels: 256 rows a pass, 48 blocks of 128 rows -> 96 of
    64; in a world of one (1024 rows): 192 -> 64 rows; at B = 16 (2048
    rows, 384 blocks) and one prime64 channel at (2^15, 16) in a world of
    one (256 blocks): 128 rows; one channel at (4096, 4, s = 2): 64 rows."""
    assert tcu64.TILE_ROWS == (128, 64)
    assert tcu64.k6_tile(4 * 64, 128, 3) == 1
    assert tcu64.k6_tile(8 * 128, 128, 3) == 1
    assert tcu64.k6_tile(16 * 128, 128, 3) == 0
    assert tcu64.k6_tile(4 * 32, 64, 1) == 1
    assert tcu64.k6_tile(16 * 256, 128, 1) == 0
    assert tcu64.k6_tile(16 * 128, 256, 1) == 0
    # every shape: whole 16-output tiles, rows a polynomial a multiple of 4
    for log_n in range(11, 16):
        n1, n2 = mxu64.four_step_factors(1 << log_n)
        for s in (1, 2, 4):
            assert n1 % tcu64.TILE_O == 0 and n2 % tcu64.TILE_O == 0
            assert (n1 // s) % 4 == 0 and (n2 // s) % 4 == 0


def test_route52_uniform_and_mixed_primes():
    """ChannelShardedNative52's route: "grid" (one K6 launch a pass) for
    Plan52's primes, which share one digit and operand plane count;
    "per-channel" for a set that mixes a 50-bit prime (7 / 7 planes) with
    a 40-bit one (5 / 6), as the JAX package's `multi_applicable`."""
    assert channels.route52(4096, tuple(PRIMES52[:3])) == "grid"
    assert channels.route52(1 << 14, tuple(PRIMES52[:1])) == "grid"
    assert (mxu64._n_dplanes(P40), mxu64._n_eplanes_lazy(P40)) != (
        mxu64._n_dplanes(PRIMES52[0]), mxu64._n_eplanes_lazy(PRIMES52[0]))
    assert channels.route52(4096, (PRIMES52[0], P40)) == "per-channel"


def test_multi_wrappers_reject_and_launch_nothing_on_cpu(rng):
    """The layout rule (the same on every device) refuses a view the kernel
    cannot copy in 16-byte chunks: interleaved limbs (row stride 2), a
    contraction stride not a multiple of 4; diagonal rows for F / A_inv,
    scales off A_inv, mixed digit-plane counts on the grid. The CPU route
    launches nothing."""
    n = 2048
    n1, n2 = mxu32.four_step_factors(n)
    before = (dict(tcu.LAUNCHES), dict(tcu64.LAUNCHES))
    pair = torch.from_numpy(rng.integers(0, 1 << 32, (2, n1, n2 // 2, 2), dtype=np.uint32))
    with pytest.raises(ValueError, match="operand strides"):
        tcu64.pass_matmod64_multi(tuple(pair[..., i].transpose(1, 2) for i in range(2)), n=n,
                                  primes=(PRIMES52[0],), which="A")
    wide = torch.zeros((2, n1, 36), dtype=torch.uint32)[:, :, :n2 // 2]  # K stride 36
    assert tcu.pass_matmod_multi(wide.transpose(1, 2), n=n, primes=(PRIMES[0],),
                                 which="A").shape == (1, 2, n2 // 2, n1)
    bad = torch.zeros((2, n1, 30), dtype=torch.uint32)
    with pytest.raises(ValueError, match="operand strides"):
        tcu.pass_matmod_multi(bad.transpose(1, 2), n=n, primes=(PRIMES[0],), which="A")
    x = torch.zeros((1, 2, n1 // 2, n2), dtype=torch.uint32)
    with pytest.raises(ValueError, match="only the A and G passes"):
        tcu.pass_matmod_multi(x, n=n, primes=(PRIMES[0],), which="F",
                              diag=tcu.multi_diag(n, (PRIMES[0],), "G", 0, n1 // 2, "cpu"))
    with pytest.raises(ValueError, match="scales"):
        tcu.pass_matmod_multi(x, n=n, primes=(PRIMES[0],), which="G", scales=(3,))
    with pytest.raises(ValueError, match="channels"):
        tcu.pass_matmod_multi(x, n=n, primes=tuple(PRIMES[:2]), which="G")
    with pytest.raises(ValueError, match="one digit-plane count"):
        tcu64._multi_pass_tables(n, (PRIMES52[0], P40), "G", (1, 1), "cpu")
    with pytest.raises(ValueError, match="one digit-plane count"):
        tcu._multi_pass_tables(n, (PRIMES[0], GENERIC), "G", 1, (1, 1), "cpu", 32)
    assert (tcu.LAUNCHES, tcu64.LAUNCHES) == before


@pytest.mark.parametrize("word", [32, 64])
def test_plain_passes_take_the_cards_few_row_products(rng, monkeypatch, word):
    """A rank's F pass at (n, B, s) = (2048, 1, 2) multiplies 16 operand
    rows, and torch._int_mm on the card takes only more than 16: the
    plain twins failed there on CUDA tensors until `mxu32.int_mm` padded
    such products. Here _int_mm keeps to the card's contract and the pass
    equals the one computed without it."""
    n, b, s = 2048, 1, 2
    held, _, swap = _route(rng, "F", n, b, s, 1, 2 if word == 64 else 1, hi=1 << 18)
    x = _view(held, swap, "strided")
    kw = dict(n=n, which="F")
    if word == 32:
        run = lambda: tcu.pass_matmod_multi(x[0], primes=(PRIMES[0],), **kw)
    else:
        run = lambda: tcu64.pass_matmod64_multi(x, primes=(PRIMES52[0],), **kw)
    want = run()
    real = torch._int_mm
    rows = []

    def card_int_mm(a, b_):
        rows.append(a.shape[0])
        if a.shape[0] <= 16:
            raise RuntimeError(f"self.size(0) needs to be greater than 16, but got {a.shape[0]}")
        return real(a, b_)

    monkeypatch.setattr(torch, "_int_mm", card_int_mm)
    got = run()
    assert min(rows) == 17  # a few-row product, padded
    for g, w in zip(got if word == 64 else (got,), want if word == 64 else (want,)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
