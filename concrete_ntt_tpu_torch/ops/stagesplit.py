"""Stage-split hybrid NTT engine: butterfly prefix + blockwise four-steps.

Counterpart of `concrete_ntt_tpu/ops/stagesplit.py`, both halves. The 64-bit
four-step kernels K5 / K7 serve one transform of up to 2^15 points. Above
that this engine runs l = log2(n / n_h) Cooley-Tukey stages as plain torch
butterfly layers and then 2^l independent size-n_h four-step transforms
(n_h = 2^14), so that `prime64.Plan(n, p)` reaches n = 2^16 and 2^17 on the
card. The 32-bit half (:548-942 of the JAX module) is the same engine around
K2 / K1b-K1d with block tables. The 32-bit kernels serve n = 2^16 and 2^17
directly, so no route of `ops/ntt_dispatch.py` takes it (as the reference's
'auto'): it is the other way to the same bits, reached through
`engine32_fused` and the four `*_hybrid32` functions, and each holds the
other on the card.

Correctness is by construction plus a complete structural proof, with no new
twiddle algebra:

* After stages [0, l) of the exact CT stage engine the remaining stages act
  independently on 2^l contiguous coefficient blocks. Block b's stages are a
  size-n_h transform whose operators come from the parent transform built
  with n1 = 2^l · n1_h (`mxu64._build_operators(n, p, n1)`):
  - the prefix acts on the n1 row space as M_fwd ⊗ I (M_fwd the exact
    2^l x 2^l block-index matrix of stages [0, l)), so
    A_parent[b-block, t-block] = M_fwd[b, t] · A_b and the per-block column
    matrices A_b are slices of A_parent: asserted for every (b, t) block
    entry in `_extract_blocks`, a complete proof of the factorization;
  - the row operators are untouched by the split: F, G are shared and d_b,
    e_b are row slices of the parent's diagonals;
  - inversely A_inv,parent[b-block, t-block] = M_inv[b, t] · A_inv,t,
    asserted the same way.
* The prefix / suffix butterflies implement M ⊗ I in representative-safe
  limb arithmetic: lazy Shoup multiplies (Montgomery for p >= 2^62, which
  includes Goldilocks) plus wrap corrections by 2^64 mod p, so the
  four-step's any-representative contract holds and the prefix output is
  the JAX package's bit pattern, which the block kernel's first pass
  digit-splits; the inverse suffix is canonical in, canonical out.

Three layers, as `ops/mxu64.py` + `ops/mxu64_cuda.py`:

  * host build (numpy + the C++ helper): `_hybrid_ops`, `_dev64`,
    `_scaled_ainv_blocks64`; every array equals the JAX package's;
  * plain torch on int64 carriers: the stage butterflies `_stage_fwd64` /
    `_stage_inv64` (XLA code in the JAX package, not a Pallas kernel, so
    plain torch is their port; on the card they run as torch ops), and the
    plain engine `fwd64` / `inv64(scale)` on `mxu64._fwd_core` /
    `_inv_core` with block tables: the CPU route, and what the kernels are
    held against on the card;
  * the kernel tier `fwd64_fused` / `inv64_fused` (`engine64_fused`): the
    same prefix / suffix around K5 with block tables (`mxu64_cuda.fwd_hyb` /
    `inv_hyb`: one launch pair for all 2^l blocks, the block on a grid
    axis, operand and result in place in the [B, n] arrays), and the
    channel-grid hybrid `fwd_multi_hybrid64` / `inv_multi_hybrid64` /
    `pointwise_inv_multi_hybrid64` around K7c / K7b / K7d with block
    tables. The JAX package launches one kernel a block and concatenates;
    that is a VMEM-shaped plan and is not carried over.

Every public function takes and returns (lo, hi) uint32 tensors and computes
on their device: a CUDA tensor launches the kernels or raises, a CPU tensor
runs the plain versions.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..golden.ntt import negacyclic_twiddles
from . import mxu32, mxu32_cuda, mxu64, mxu64_cuda
from .mxu32 import _dev
from .table_cache import cached_arrays
from .u32 import (
    MASK32,
    add64,
    add64c,
    add_mod,
    add_mod64,
    cond_sub64,
    const64_like,
    mont_mul,
    mont_mul64,
    mont_neginv,
    mont_neginv64,
    select64,
    shoup_mul_lazy,
    shoup_mul_lazy64,
    sub64,
    sub64b,
    to_i64,
    to_u32,
)

N_H = 1 << 14  # block transform size


def applicable64(n: int, p: int, n_h: int = N_H) -> bool:
    """Hybrid applies above the block size (odd 2^33 < p < 2^64; any regime)."""
    return n > n_h and (n & (n - 1)) == 0 and mxu64.applicable(n_h, p)


# ---------------------------------------------------------------------------
# Host build: per-block operators by slicing the parent transform
# ---------------------------------------------------------------------------


def _cross_mats(l: int, twid, inv_twid, p: int):
    """Exact 2^l x 2^l block-index matrices of stages [0, l) (fwd) and the
    matching inverse stages. The cross stages pair whole blocks with
    per-pair twiddles twid[m + i], which on the block index is literally a
    size-2^l stage engine run over the global table's first entries."""
    nb = 1 << l
    tw = np.array(twid[:nb], dtype=object)
    itw = np.array(inv_twid[:nb], dtype=object)
    Mf = np.zeros((nb, nb), dtype=object)
    Mi = np.zeros((nb, nb), dtype=object)
    for i in range(nb):
        basis = np.zeros((1, nb), dtype=object)
        basis[0, i] = 1
        Mf[:, i] = mxu64._fwd_stage_range_obj(basis.copy(), tw, p, 0, l)[0]
        basis = np.zeros((1, nb), dtype=object)
        basis[0, i] = 1
        Mi[:, i] = mxu64._inv_stage_range_obj(basis.copy(), itw, p, l, 0)[0]
    return Mf, Mi


def _extract_blocks(par_mat: np.ndarray, M: np.ndarray, n1h: int, p: int,
                    which: str, side: str):
    """Per-block n1h x n1h matrices from the parent column operator.

    side="row"  (fwd A, applied AFTER the prefix: block-diagonal on the
    output side): parent[b-block, t-block] = M[b, t]·B_b.
    side="col"  (inv Ainv, applied BEFORE the suffix: block-diagonal on the
    input side): parent[b-block, t-block] = M[b, t]·B_t.
    Every block entry is asserted: a complete factorization proof."""
    nb = M.shape[0]
    A = par_mat.astype(object)

    def blk(b, t):
        return A[b * n1h : (b + 1) * n1h, t * n1h : (t + 1) * n1h]

    blocks = []
    for i in range(nb):
        if side == "row":
            j = next(t for t in range(nb) if int(M[i, t]) != 0)
            raw, m0 = blk(i, j), int(M[i, j])
        else:
            j = next(b for b in range(nb) if int(M[b, i]) != 0)
            raw, m0 = blk(j, i), int(M[j, i])
        blocks.append(raw * pow(m0, p - 2, p) % p)
    for b in range(nb):
        for t in range(nb):
            base = blocks[b] if side == "row" else blocks[t]
            expect = base * int(M[b, t]) % p
            assert (blk(b, t) == expect).all(), (
                f"stage-split {which} factorization fails at block ({b},{t})"
            )
    return [b.astype(np.uint64) for b in blocks]


def _build_hybrid_ops(n: int, p: int, n_h: int):
    l = (n // n_h).bit_length() - 1
    nb = 1 << l
    n1h, n2 = mxu64.four_step_factors(n_h)
    par = mxu64._build_operators(n, p, n1=nb * n1h)
    twid, inv_twid = negacyclic_twiddles(p, n)
    Mf, Mi = _cross_mats(l, twid, inv_twid, p)
    A_blocks = _extract_blocks(par["A"], Mf, n1h, p, "fwd", "row")
    Ainv_blocks = _extract_blocks(par["Ainv"], Mi, n1h, p, "inv", "col")
    out = {
        "F": par["F"],
        "G": par["G"],
        # canonical stage twiddles for the prefix / suffix butterflies
        "tw": np.array([int(t) for t in twid[:nb]], dtype=np.uint64),
        "itw": np.array([int(t) for t in inv_twid[:nb]], dtype=np.uint64),
    }
    for b in range(nb):
        out[f"A{b}"] = A_blocks[b]
        out[f"Ainv{b}"] = Ainv_blocks[b]
        out[f"d{b}"] = par["d"][b * n1h : (b + 1) * n1h]
        out[f"e{b}"] = par["e"][b * n1h : (b + 1) * n1h]
    assert out["F"].shape == (n2, n2) and out[f"d{nb-1}"].shape == (n1h, n2)
    return out


@lru_cache(maxsize=32)
def _hybrid_ops(n: int, p: int, n_h: int):
    return cached_arrays(
        f"stagesplit_{n}_{p}_{n_h}", lambda: _build_hybrid_ops(n, p, n_h)
    )


# ---------------------------------------------------------------------------
# Stage butterflies (representative-safe limb arithmetic on int64 carriers)
# ---------------------------------------------------------------------------


def _add_rep64(a, b, c64):
    """a + b as a valid u64 representative for ANY representatives a, b:
    each 2^64 wrap is compensated by adding 2^64 mod p (< 2^63, so the
    second correction cannot wrap again)."""
    s, c = add64c(a, b)
    s, c2 = add64c(s, (c * c64[0], c * c64[1]))
    return add64(s, (c2 * c64[0], c2 * c64[1]))


def _sub_rep64(a, b, c64):
    """a - b as a valid u64 representative for ANY representatives a, b."""
    d, bo = sub64b(a, b)
    bo = bo.to(torch.int64)  # 0 / 1: it multiplies the limb constants
    d, bo2 = sub64b(d, (bo * c64[0], bo * c64[1]))
    bo2 = bo2.to(torch.int64)
    return sub64(d, (bo2 * c64[0], bo2 * c64[1]))


def _sub_mod64_canon(a, b, p: int):
    """(a - b) mod p canonical for canonical a, b in [0, p)."""
    d, bo = sub64b(a, b)
    return select64(bo, add64(d, const64_like(p)), d)


def _tw_dev(w_tab, device):
    """A stage's twiddle table (numpy limb pairs) as carrier tensors."""
    return tuple(tuple(_dev(a, device) for a in pair) for pair in w_tab)


def _stage_fwd64(parts, w_tab, sc):
    """One forward CT stage on [B, n] carrier limb pairs; any-representative
    in and out. w_tab: per-block twiddle constant pairs shaped [1, m, 1]."""
    lo, hi = parts
    b, n = lo.shape
    w_tab = _tw_dev(w_tab, lo.device)
    m = w_tab[0][0].shape[1]
    t = n // (2 * m)
    v = tuple(a.reshape(b, m, 2, t) for a in (lo, hi))
    z0 = tuple(a[:, :, 0, :] for a in v)
    z1 = tuple(a[:, :, 1, :] for a in v)
    if sc["mont"]:
        wz1 = mont_mul64(z1, w_tab[0], sc["p"], sc["neginv"])
    else:
        wz1 = shoup_mul_lazy64(z1, w_tab[0], w_tab[1], sc["p"])
    top = _add_rep64(z0, wz1, sc["c64"])
    bot = _sub_rep64(z0, wz1, sc["c64"])
    return tuple(
        torch.stack([a, c], dim=2).reshape(b, n) for a, c in zip(top, bot)
    )


def _stage_inv64(parts, w_tab, sc):
    """One inverse GS stage; canonical [0, p) in and out."""
    lo, hi = parts
    b, n = lo.shape
    w_tab = _tw_dev(w_tab, lo.device)
    m = w_tab[0][0].shape[1]
    t = n // (2 * m)
    p = sc["p"]
    v = tuple(a.reshape(b, m, 2, t) for a in (lo, hi))
    y0 = tuple(a[:, :, 0, :] for a in v)
    y1 = tuple(a[:, :, 1, :] for a in v)
    top = add_mod64(y0, y1, p)
    d = _sub_mod64_canon(y0, y1, p)
    if sc["mont"]:
        bot = mont_mul64(d, w_tab[0], p, sc["neginv"])  # canonical: d < p
    else:
        bot = cond_sub64(shoup_mul_lazy64(d, w_tab[0], w_tab[1], p), p)
    return tuple(
        torch.stack([a, c], dim=2).reshape(b, n) for a, c in zip(top, bot)
    )


# ---------------------------------------------------------------------------
# Tables + the plain engine
# ---------------------------------------------------------------------------


def _split_u64(vals: np.ndarray, shape):
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    hi = (vals >> np.uint64(32)).astype(np.uint32).reshape(shape)
    return lo, hi


def _stage_tabs(tw: np.ndarray, p: int, mont: bool):
    """Per-stage twiddle tables: stage s uses entries [2^s, 2^(s+1)) shaped
    [1, m, 1]. Shoup pairs for p < 2^62; W·2^64 mod p for mont."""
    l = tw.shape[0].bit_length() - 1
    tabs = []
    for s in range(l):
        w = [int(x) for x in tw[1 << s : 2 << s]]
        shape = (1, 1 << s, 1)
        if mont:
            wt = np.array([(x << 64) % p for x in w], dtype=np.uint64)
            tabs.append((_split_u64(wt, shape),))
        else:
            w64 = np.array(w, dtype=np.uint64)
            wsh = np.array([(x << 64) // p for x in w], dtype=np.uint64)
            tabs.append((_split_u64(w64, shape), _split_u64(wsh, shape)))
    return tabs


@lru_cache(maxsize=32)
def _dev64(n: int, p: int, n_h: int):
    ops = _hybrid_ops(n, p, n_h)
    l = (n // n_h).bit_length() - 1
    nb = 1 << l
    n1h, n2 = mxu64.four_step_factors(n_h)
    mont = p >= (1 << 62)
    blocks = tuple(
        mxu64._tables_from_ops(
            n1h,
            n2,
            p,
            {
                "A": ops[f"A{b}"],
                "F": ops["F"],
                "d": ops[f"d{b}"],
                "G": ops["G"],
                "e": ops[f"e{b}"],
                "Ainv": ops[f"Ainv{b}"],
            },
        )
        for b in range(nb)
    )
    sc = {
        "p": p,
        "mont": mont,
        "neginv": mont_neginv64(p),
        "c64": const64_like((1 << 64) % p),
    }
    return {
        "l": l,
        "blocks": blocks,
        "sc": sc,
        "fwd_tw": _stage_tabs(ops["tw"], p, mont),
        "inv_tw": _stage_tabs(ops["itw"], p, mont),
    }


@lru_cache(maxsize=32)
def _scaled_ainv_blocks64(n: int, p: int, n_h: int, scale: int):
    ops = _hybrid_ops(n, p, n_h)
    nb = n // n_h
    out = []
    for b in range(nb):
        M = (ops[f"Ainv{b}"].T.astype(object) * scale % p).astype(np.uint64)
        out.append(mxu64._prep64(M, p, mxu64._n_eplanes_lazy(p)))
    return tuple(out)


def _prefix64(x, dv):
    for s in range(dv["l"]):
        x = _stage_fwd64(x, dv["fwd_tw"][s], dv["sc"])
    return x


def _suffix64(x, dv):
    for s in range(dv["l"] - 1, -1, -1):
        x = _stage_inv64(x, dv["inv_tw"][s], dv["sc"])
    return x


def _blocks_fwd64(x, dv, n_h: int):
    """The 2^l block transforms of carrier limbs [B, n], plain torch."""
    b = x[0].shape[0]
    nb = 1 << dv["l"]
    xb = tuple(a.reshape(b, nb, n_h) for a in x)
    outs = [
        mxu64._fwd_core(tuple(a[:, i, :] for a in xb), dv["blocks"][i])
        for i in range(nb)
    ]
    return tuple(torch.cat([o[j] for o in outs], dim=-1) for j in range(2))


def _blocks_inv64(x, dv, n_h: int, mats):
    b = x[0].shape[0]
    nb = 1 << dv["l"]
    xb = tuple(a.reshape(b, nb, n_h) for a in x)
    outs = [
        mxu64._inv_core(tuple(a[:, i, :] for a in xb), dv["blocks"][i], mats[i])
        for i in range(nb)
    ]
    return tuple(torch.cat([o[j] for o in outs], dim=-1) for j in range(2))


def _ainv_mats(n: int, p: int, n_h: int, scale: int):
    """Per-block second-pass matrices of the inverse: None (the block's own
    A_inv) for a unit scale, else A_inv,b times the scale."""
    if scale % p == 1:
        return [None] * (n // n_h)
    return _scaled_ainv_blocks64(n, p, n_h, scale % p)


def _carriers(limbs):
    return tuple(to_i64(a) for a in limbs)


def _pair_u32(x):
    return tuple(to_u32(a) for a in x)


def fwd64(limbs: tuple, *, n: int, p: int, n_h: int = N_H):
    """Hybrid forward, plain torch: l butterfly stages + 2^l blockwise
    four-steps. Bit-identical to `mxu64.fwd`."""
    dv = _dev64(n, p, n_h)
    return _pair_u32(_blocks_fwd64(_prefix64(_carriers(limbs), dv), dv, n_h))


def inv64(limbs: tuple, *, n: int, p: int, scale: int = 1, n_h: int = N_H):
    """Hybrid inverse, plain torch: blockwise four-steps + l canonical
    suffix stages. Bit-identical to `mxu64.inv` (optional folded scale)."""
    dv = _dev64(n, p, n_h)
    x = _blocks_inv64(_carriers(limbs), dv, n_h, _ainv_mats(n, p, n_h, scale))
    return _pair_u32(_suffix64(x, dv))


# ---------------------------------------------------------------------------
# Kernel tier: prefix / suffix in plain torch, all blocks in one launch pair
# of K5 with block tables
# ---------------------------------------------------------------------------


def fwd64_fused(limbs: tuple, *, n: int, p: int, n_h: int = N_H):
    """Hybrid forward with the blocks on K5 with block tables."""
    dv = _dev64(n, p, n_h)
    x = _pair_u32(_prefix64(_carriers(limbs), dv))
    return mxu64_cuda.fwd_hyb(x, n=n, p=p, n_h=n_h)


def inv64_fused(limbs: tuple, *, n: int, p: int, scale: int = 1,
                n_h: int = N_H):
    """Hybrid inverse with the blocks on K5 with block tables."""
    dv = _dev64(n, p, n_h)
    x = mxu64_cuda.inv_hyb(tuple(limbs), n=n, p=p, n_h=n_h, scale=scale)
    return _pair_u32(_suffix64(_carriers(x), dv))


class _Engine64:
    """Dispatch shim with the mxu64 engine surface (u64 limb pairs only)."""

    def __init__(self, fused: bool):
        self._fused = fused

    def fwd(self, limbs, *, n, p):
        assert len(limbs) == 2, "hybrid engine is u64-pair only"
        return (fwd64_fused if self._fused else fwd64)(limbs, n=n, p=p)

    def inv(self, limbs, *, n, p, scale=1):
        assert len(limbs) == 2, "hybrid engine is u64-pair only"
        f = inv64_fused if self._fused else inv64
        return f(limbs, n=n, p=p, scale=scale)


engine64_fused = _Engine64(fused=True)
engine64_xla = _Engine64(fused=False)  # the JAX module's name: the plain engine


# ---------------------------------------------------------------------------
# Channel-grid hybrid (Plan52 CRT channels above the block size): per-channel
# prefix stages + the channel-grid kernels with block tables
# ---------------------------------------------------------------------------


def multi_hybrid_applicable64(n: int, primes, n_h: int = N_H) -> bool:
    return n > n_h and mxu64.multi_applicable(n_h, primes) and all(
        applicable64(n, p, n_h) for p in primes
    )


def _prefix_fwd_per_channel64(limbs, primes, n, n_h):
    """l forward stages per channel on the SHARED u64 input (the butterfly
    twiddles differ per channel) -> stacked [C, B, n] limb pair."""
    x = _carriers(limbs)
    parts = [_prefix64(x, _dev64(n, p, n_h)) for p in primes]
    return tuple(to_u32(torch.stack([c[j] for c in parts], dim=0)) for j in range(2))


def _suffix_inv_per_channel64(lo, hi, primes, n, n_h):
    outs = [
        _suffix64((to_i64(lo[ch]), to_i64(hi[ch])), _dev64(n, p, n_h))
        for ch, p in enumerate(primes)
    ]
    return tuple(to_u32(torch.stack([o[j] for o in outs], dim=0)) for j in range(2))


def fwd_multi_hybrid64(limbs: tuple, primes: tuple, *, n: int,
                       n_h: int = N_H):
    """Hybrid channel-grid forward: (lo, hi) [B, n] shared limb pair ->
    (lo, hi) of [C, B, n] canonical NTT-domain residues (matches
    `mxu64_cuda.fwd_multi` bit for bit)."""
    lo, hi = _prefix_fwd_per_channel64(limbs, primes, n, n_h)
    return mxu64_cuda.fwd_multi_perchannel64(lo, hi, tuple(primes), n_h=n_h)


def inv_multi_hybrid64(x_lo, x_hi, primes: tuple, scales: tuple, *, n: int,
                       n_h: int = N_H):
    """Hybrid channel-grid scaled inverse (matches `mxu64_cuda.inv_multi`)."""
    lo, hi = mxu64_cuda.inv_multi(x_lo, x_hi, tuple(primes), tuple(scales), n_h=n_h)
    return _suffix_inv_per_channel64(lo, hi, primes, n, n_h)


def pointwise_inv_multi_hybrid64(fl, fr, primes: tuple, scales: tuple, *,
                                 n: int, n_h: int = N_H):
    """Hybrid pointwise-Montgomery + scaled inverse (matches
    `mxu64_cuda.pointwise_inv_multi`): the pointwise product is elementwise
    in the NTT domain, so it runs inside the block kernel's load."""
    lo, hi = mxu64_cuda.pointwise_inv_multi(
        tuple(fl), tuple(fr), tuple(primes), tuple(scales), n_h=n_h
    )
    return _suffix_inv_per_channel64(lo, hi, primes, n, n_h)


# ---------------------------------------------------------------------------
# 32-bit hybrid (prime32): same host build, u32 stage butterflies on int64
# carriers
# ---------------------------------------------------------------------------


def applicable32(n: int, p: int, variant: str, n_h: int = N_H) -> bool:
    return n > n_h and (n & (n - 1)) == 0 and mxu32.applicable(n_h, p, variant)


def _stage_tabs32(tw: np.ndarray, p: int, mont: bool):
    """Per-stage twiddle tables, stage s the entries [2^s, 2^(s+1)) shaped
    [1, m, 1]: Shoup pairs for p < 2^31, W * 2^32 mod p for mont."""
    l = tw.shape[0].bit_length() - 1
    tabs = []
    for s in range(l):
        w = [int(x) for x in tw[1 << s : 2 << s]]
        shape = (1, 1 << s, 1)
        if mont:
            tabs.append((np.array([(x << 32) % p for x in w], np.uint32).reshape(shape),))
        else:
            tabs.append((
                np.array(w, np.uint32).reshape(shape),
                np.array([(x << 32) // p for x in w], np.uint32).reshape(shape),
            ))
    return tabs


def _add_rep32(a, b, c32: int):
    """a + b as a valid u32 representative for ANY representatives (each
    2^32 wrap compensated by + 2^32 mod p; c32 < 2^31, so at most two). In
    int64 carriers the wrap is bit 32 of the exact sum."""
    s = a + b
    s2 = (s & MASK32) + (s >> 32) * c32
    return ((s2 & MASK32) + (s2 >> 32) * c32) & MASK32


def _sub_rep32(a, b, c32: int):
    """a - b as a valid u32 representative for ANY representatives: each
    borrow (a negative exact difference) is compensated by - 2^32 mod p."""
    d = a - b
    d2 = (d & MASK32) - (d < 0).to(torch.int64) * c32
    return ((d2 & MASK32) - (d2 < 0).to(torch.int64) * c32) & MASK32


def _stage_fwd32(x, w_tab, sc):
    """One forward CT stage on a [B, n] carrier; any-representative in and
    out (Shoup lazy below 2^31, Montgomery above)."""
    b, n = x.shape
    w_tab = tuple(_dev(a, x.device) for a in w_tab)
    m = w_tab[0].shape[1]
    t = n // (2 * m)
    v = x.reshape(b, m, 2, t)
    z0, z1 = v[:, :, 0, :], v[:, :, 1, :]
    if sc["mont"]:
        wz1 = mont_mul(z1, w_tab[0], sc["p"], sc["neginv"])
    else:
        wz1 = shoup_mul_lazy(z1, w_tab[0], w_tab[1], sc["p"])
    top = _add_rep32(z0, wz1, sc["c32"])
    bot = _sub_rep32(z0, wz1, sc["c32"])
    return torch.stack([top, bot], dim=2).reshape(b, n)


def _stage_inv32(x, w_tab, sc):
    """One inverse GS stage; canonical [0, p) in and out."""
    b, n = x.shape
    w_tab = tuple(_dev(a, x.device) for a in w_tab)
    m = w_tab[0].shape[1]
    t = n // (2 * m)
    p = sc["p"]
    v = x.reshape(b, m, 2, t)
    y0, y1 = v[:, :, 0, :], v[:, :, 1, :]
    top = add_mod(y0, y1, p)
    d = torch.where(y0 >= y1, y0 - y1, (y0 - y1 + p) & MASK32)
    if sc["mont"]:
        bot = mont_mul(d, w_tab[0], p, sc["neginv"])
    else:
        tl = shoup_mul_lazy(d, w_tab[0], w_tab[1], p)
        bot = torch.where(tl >= p, tl - p, tl)
    return torch.stack([top, bot], dim=2).reshape(b, n)


@lru_cache(maxsize=32)
def _dev32(n: int, p: int, n_h: int):
    ops = _hybrid_ops(n, p, n_h)
    l = (n // n_h).bit_length() - 1
    nb = 1 << l
    n1h, n2 = mxu32.four_step_factors(n_h)
    mont = p >= (1 << 31)
    blocks = tuple(
        mxu32._mxu_tables_from_ops(
            n1h,
            n2,
            p,
            {
                "A": ops[f"A{b}"],
                "F": ops["F"],
                "d": ops[f"d{b}"],
                "G": ops["G"],
                "e": ops[f"e{b}"],
                "Ainv": ops[f"Ainv{b}"],
            },
        )
        for b in range(nb)
    )
    sc = {"p": p, "mont": mont, "neginv": mont_neginv(p), "c32": (1 << 32) % p}
    return {
        "l": l,
        "blocks": blocks,
        "sc": sc,
        "fwd_tw": _stage_tabs32(ops["tw"], p, mont),
        "inv_tw": _stage_tabs32(ops["itw"], p, mont),
    }


@lru_cache(maxsize=64)
def _scaled_ainv_blocks32(n: int, p: int, n_h: int, scale: int):
    ops = _hybrid_ops(n, p, n_h)
    out = []
    for b in range(n // n_h):
        M = (ops[f"Ainv{b}"].T.astype(object) * scale % p).astype(np.uint64)
        out.append(mxu32._prep(M, p))
    return tuple(out)


def _prefix32(x, dv):
    for s in range(dv["l"]):
        x = _stage_fwd32(x, dv["fwd_tw"][s], dv["sc"])
    return x


def _suffix32(x, dv):
    for s in range(dv["l"] - 1, -1, -1):
        x = _stage_inv32(x, dv["inv_tw"][s], dv["sc"])
    return x


def fwd32(x, *, n: int, p: int, n_h: int = N_H):
    """Hybrid forward, plain torch: l butterfly stages + 2^l blockwise
    four-steps. [B, n] uint32 -> the bits of `mxu32.fwd`."""
    dv = _dev32(n, p, n_h)
    return to_u32(mxu32_cuda._fwd_blocks((_prefix32(to_i64(x), dv),), p, n_h))


def inv32(x, *, n: int, p: int, scale: int = 1, n_h: int = N_H):
    """Hybrid inverse, plain torch: blockwise four-steps + l canonical
    suffix stages. The bits of `mxu32.inv` (optional folded scale)."""
    dv = _dev32(n, p, n_h)
    return to_u32(_suffix32(mxu32_cuda._inv_blocks(to_i64(x), p, scale, n_h), dv))


def fwd32_fused(x, *, n: int, p: int, n_h: int = N_H):
    """Hybrid forward with the blocks on K2 with block tables."""
    dv = _dev32(n, p, n_h)
    return mxu32_cuda.fwd_hyb(to_u32(_prefix32(to_i64(x), dv)), n=n, p=p, n_h=n_h)


def inv32_fused(x, *, n: int, p: int, scale: int = 1, n_h: int = N_H):
    """Hybrid inverse with the blocks on K2 with block tables."""
    dv = _dev32(n, p, n_h)
    y = mxu32_cuda.inv_hyb(x, n=n, p=p, n_h=n_h, scale=scale)
    return to_u32(_suffix32(to_i64(y), dv))


class _Engine32:
    """Dispatch shim with the mxu32 engine surface (single u32 arrays)."""

    def __init__(self, fused: bool):
        self._fused = fused

    def fwd(self, x, *, n, p):
        return (fwd32_fused if self._fused else fwd32)(x, n=n, p=p)

    def inv(self, x, *, n, p, scale=1):
        return (inv32_fused if self._fused else inv32)(x, n=n, p=p, scale=scale)


engine32_fused = _Engine32(fused=True)
engine32_xla = _Engine32(fused=False)  # the JAX module's name: the plain engine


# ---------------------------------------------------------------------------
# 32-bit channel-grid hybrid (native-plan prime32 channels above the block
# size): per-channel prefix stages + K1c / K1b / K1d with block tables
# ---------------------------------------------------------------------------


@lru_cache(maxsize=64)
def _wide_block_planes32(n: int, p: int, n_h: int, block: int, n_limbs: int):
    """Per-block column planes consuming u{32*n_limbs} limb tuples (the
    fused residue split, 4 * n_limbs operand planes)."""
    ops = _hybrid_ops(n, p, n_h)
    return mxu32._prep(ops[f"A{block}"].T, p, n_eplanes=4 * n_limbs)


@lru_cache(maxsize=32)
def _dev32w(n: int, p: int, n_h: int):
    """u64-limb-pair prefix-stage tables for a 30-bit channel prime: the
    prefix butterflies run in 64-bit limb algebra mod p (Shoup lazy: any
    p < 2^62), so the residue split stays fused into the block matmuls."""
    ops = _hybrid_ops(n, p, n_h)
    sc = {"p": p, "mont": False, "neginv": 0, "c64": const64_like((1 << 64) % p)}
    return {"sc": sc, "fwd_tw": _stage_tabs(ops["tw"], p, False)}


def multi_hybrid_applicable32(n: int, primes, n_h: int = N_H) -> bool:
    return (
        n > n_h
        and (n & (n - 1)) == 0
        and mxu32_cuda.MIN_N <= n_h <= mxu32_cuda.MAX_N
        and all((1 << 29) < p < (1 << 30) for p in primes)
    )


def _prefix_fwd_channels32(x_per_ch, primes, n, n_h):
    """l u32 forward stages per channel on per-channel residue arrays
    (uint32 [B, n] each) -> uint32 [C, B, n]."""
    outs = [_prefix32(to_i64(x), _dev32(n, p, n_h)) for x, p in zip(x_per_ch, primes)]
    return to_u32(torch.stack(outs, dim=0))


def fwd_wide_multi_hybrid32(limbs: tuple, primes: tuple, *, n: int, n_h: int = N_H):
    """Hybrid channel-grid forward for native plans: shared limb tuple
    (1 = u32 values, 2 = u64) of [B, n] uint32 -> [C, B, n] canonical
    NTT-domain residues (the bits of `mxu32_cuda.fwd_wide_multi`)."""
    primes = tuple(primes)
    if len(limbs) == 1:
        # u32 values are valid residue representatives for every channel
        x = _prefix_fwd_channels32([limbs[0]] * len(primes), primes, n, n_h)
        return mxu32_cuda.fwd_multi_perchannel(x, primes, n_h=n_h)
    if len(limbs) != 2:
        raise NotImplementedError("u128 operands keep the direct path")
    xs = _carriers(limbs)
    parts = []
    for p in primes:
        dv = _dev32w(n, p, n_h)
        y = xs
        for tab in dv["fwd_tw"]:
            y = _stage_fwd64(y, tab, dv["sc"])
        parts.append(y)
    lo, hi = (to_u32(torch.stack([c[j] for c in parts], dim=0)) for j in range(2))
    return mxu32_cuda.fwd_wide_multi_perchannel(lo, hi, primes, n_h=n_h)


def fwd_perchannel_multi_hybrid32(x, primes: tuple, *, n: int, n_h: int = N_H):
    """Hybrid per-channel-input forward (the Bounded product path): x
    [C, B, n] uint32 -> [C, B, n] canonical NTT-domain residues."""
    primes = tuple(primes)
    xc = _prefix_fwd_channels32([x[ch] for ch in range(len(primes))], primes, n, n_h)
    return mxu32_cuda.fwd_multi_perchannel(xc, primes, n_h=n_h)


def _suffix_inv_channels32(x, primes, n, n_h):
    outs = [_suffix32(to_i64(x[ch]), _dev32(n, p, n_h)) for ch, p in enumerate(primes)]
    return to_u32(torch.stack(outs, dim=0))


def inv_multi_hybrid32(x, primes: tuple, scales: tuple, *, n: int, n_h: int = N_H):
    """Hybrid channel-grid scaled inverse (the bits of
    `mxu32_cuda.inv_multi`)."""
    y = mxu32_cuda.inv_multi(x, tuple(primes), tuple(scales), n_h=n_h)
    return _suffix_inv_channels32(y, primes, n, n_h)


def pointwise_inv_multi_hybrid32(fl, fr, primes: tuple, scales: tuple, *, n: int,
                                 n_h: int = N_H):
    """Hybrid pointwise-Montgomery + scaled inverse (the bits of
    `mxu32_cuda.pointwise_inv_multi`): the product is elementwise in the NTT
    domain, so it runs inside the block kernel's load."""
    y = mxu32_cuda.pointwise_inv_multi(fl, fr, tuple(primes), tuple(scales), n_h=n_h)
    return _suffix_inv_channels32(y, primes, n, n_h)
