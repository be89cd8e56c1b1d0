"""Four-step prime64 NTT as two exact int8 modular matrix products.

Counterpart of `concrete_ntt_tpu/ops/mxu64.py` (and of the table stacking
of `mxu64_pallas.py`), in two halves as `ops/mxu32.py`:

  * **Host half (numpy + `csrc/hostmath64.cpp`).** The six four-step
    operators A, F, d, G, e, A_inv of (n, p) and their balanced-digit int8
    planes, built by the port's own C++ helper (`ops/host_build.py`; a
    64 x 64-bit product mod p does not fit numpy's uint64) and cached on
    disk (`ops/table_cache.py`); the plane counts (`_n_dplanes`,
    `_n_eplanes_lazy`), the epilogue regime (`_scale_mode`), the diagonal
    tables (`_scale_tables64`), the table dict (`_tables`), A_inv times a
    constant (`_scaled_ainv_planes`), and the channel grid's stacked tables
    and 16-word scalar record (`_multi_tables64`, `_scal_vec64`; with `hyb`
    the block tables of the stage-split hybrid, `ops/stagesplit.py`, which
    also builds a parent transform with its own n1 and the exact stage
    engine on Python integers, `_fwd_stage_range_obj`). The tests assert
    every array equals the JAX package's.
  * **Device half, plain torch.** `_digit_cat`, `_dot` (`mxu32.int_mm`),
    the 3-limb combine, the top-limb fold, the two epilogues, `fwd`,
    `inv(scale)`, one pass (`pass_plain`) and the channel-grid twins that
    read the scalar record (`_sc_*`). This is the plain version the kernels
    of `ops/mxu64_cuda.py` (K5, K6, K7a-K7d, direct and with block tables)
    are held against, and the CPU route.

The algebra is `ops/mxu32.py`'s, widened: operands are u64 limb pairs split
into 8 unsigned digit planes; matrix entries are centred to (-p/2, p/2] and
split into D = 7, 8 or 9 balanced radix-256 planes (by the size of p); the
int32 accumulators recombine into a three-limb value V < 2^93, whose top
limb folds back by 2^64 mod p. Four epilogue regimes:

  * shoup (p < 2^62): scaled epilogue = two lazy Shoup multiplies,
    (v0, v1)·W + v2·(2^64·W), result < 4p; canonical = Shoup fold, then an
    approximate Barrett quotient and two conditional subtracts;
  * mont, Shoup fold (2^62 <= p < 2^63): fold, then a Montgomery multiply
    against W·2^64 mod p; canonical = fold, cond_sub 2p, cond_sub p;
  * mont, Montgomery fold (p >= 2^63, not Goldilocks): the top limb folds
    through mont_mul64 by 2^128 mod p (Shoup's 2p bound passes 2^64), with a
    second carry round; canonical = fold, one cond_sub;
  * gl (Goldilocks): shift/add fold (2^64 ≡ 2^32 - 1), then gl_mul_lazy.

Mid-pass values are any-u64 representatives that the next pass digit-splits,
so every step reproduces the JAX limb-pair code's bit pattern, not just its
residue class.

Device-half carrier convention (ops/u32.py): u32 values are held in int64
tensors; `fwd` / `inv` / `pass_plain` take and return uint32 tensors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..golden.ntt import negacyclic_twiddles
from ..tables import GOLDILOCKS
from . import host_build
from .mxu32 import _dev, assert_accumulator_exact, four_step_factors, int_mm, off_delta
from .table_cache import cached_operators
from .u32 import (
    MASK32,
    add64,
    add64c,
    cond_sub64,
    const64_like,
    gl_mul_lazy,
    mont_mul64,
    mont_neginv64,
    mulhi64,
    mullo64,
    shoup_mul_lazy64,
    shoup_mul_u32_lazy64,
    sub64,
    to_i64,
    to_u32,
)

# ---------------------------------------------------------------------------
# Host half
# ---------------------------------------------------------------------------


def _n_dplanes(p: int) -> int:
    """Matrix digit planes: the smallest D whose balanced radix-256 digits
    cover the centred entries |v| <= p/2 (largest positive value
    127·(256^D - 1)/255): 7 for the ~50-bit Plan52 primes, 8 up to about
    2^62.99, 9 above (Goldilocks)."""
    d = 1
    while p // 2 > 127 * ((1 << (8 * d)) - 1) // 255:
        d += 1
    return d


def _scale_mode(p: int) -> str:
    """Regime of the scaled epilogue: "shoup" (2^33 < p < 2^62: the lazy
    [0, 2p) bounds need 4p < 2^64), "gl" (Goldilocks), "mont" (other
    p >= 2^62)."""
    if p == GOLDILOCKS:
        return "gl"
    return "shoup" if p < (1 << 62) else "mont"


def _n_eplanes_lazy(p: int) -> int:
    """Operand digit planes of MID-PASS values: the shoup epilogue emits
    values < 4p, so ceil(bits(4p)/8) planes (7 for the Plan52 primes); the gl
    and mont epilogues emit any u64, so 8. Raw inputs always take 8."""
    if _scale_mode(p) != "shoup":
        return 8
    return min(8, ((4 * p - 1).bit_length() + 7) // 8)


def applicable(n: int, p: int) -> bool:
    """Every odd modulus in (2^33, 2^64), n a power of two >= 2048 whose row
    pass contracts at most 4096 digit rows (8·n2 <= 4096, n <= 2^18): the
    bound up to which the int8 accumulators are provably exact."""
    if n < 2048 or (n & (n - 1)) != 0:
        return False
    if 8 * four_step_factors(n)[1] > 4096:
        return False
    return p % 2 == 1 and (1 << 33) < p < (1 << 64)


@lru_cache(maxsize=32)
def _operators(n: int, p: int):
    """The six four-step operators (uint64 mod p), disk-cached."""
    return cached_operators(n, p, lambda: _build_operators(n, p))


def _build_operators(n: int, p: int, n1: int | None = None):
    """The six operators of (n, p) for the split n = n1 · n2 (default: the
    balanced `four_step_factors`; the stage-split hybrid asks for the parent
    transform with n1 = 2^l · n1_h, `ops/stagesplit.py`)."""
    twid, inv_twid = negacyclic_twiddles(p, n)
    if n1 is None:
        n1 = four_step_factors(n)[0]
    return host_build.fourstep_build(n, p, n1, twid, inv_twid)


def _fwd_stage_range_obj(data, twid, p, s0, s1):
    """Forward CT stages [s0, s1) of the exact stage engine on object-dtype
    rows [rows, n] (Python integers): the hybrid's 2^l x 2^l block-index
    matrices come from it (`stagesplit._cross_mats`)."""
    rows, n = data.shape
    for s in range(s0, s1):
        m = 1 << s
        t = n >> (s + 1)
        v = data.reshape(rows, m, 2, t)
        z0 = v[:, :, 0, :].copy()
        z1 = v[:, :, 1, :]
        wz1 = z1 * twid[m : 2 * m][None, :, None] % p
        v[:, :, 0, :] = (z0 + wz1) % p
        v[:, :, 1, :] = (z0 - wz1) % p
    return data


def _inv_stage_range_obj(data, inv_twid, p, s_hi, s_lo):
    """Inverse GS stages s_hi - 1 down to s_lo, as `_fwd_stage_range_obj`."""
    rows, n = data.shape
    for s in range(s_hi - 1, s_lo - 1, -1):
        m = 1 << s
        t = n >> (s + 1)
        v = data.reshape(rows, m, 2, t)
        z0 = v[:, :, 0, :].copy()
        z1 = v[:, :, 1, :]
        v[:, :, 0, :] = (z0 + z1) % p
        v[:, :, 1, :] = (z0 - z1) * inv_twid[m : 2 * m][None, :, None] % p
    return data


def _prep64(M: np.ndarray, p: int, n_eplanes: int = 8):
    """Digit-plane packing of M [K, O] for `n_eplanes` operand planes, with
    the sign offsets folded to ≡ 0 mod p (`mxu32.off_delta`), so that no
    epilogue carries an offset correction."""
    n_d = _n_dplanes(p)
    planes, cvec = host_build.prep_matrix(M, p, n_eplanes, n_d)
    cvec = (cvec.astype(np.int64) + off_delta(p, n_d)[:, None]).astype(np.int32)
    assert_accumulator_exact(planes, cvec)
    return planes, cvec


def _scale_tables64(W: np.ndarray, p: int):
    """Per-element tables of the scaled epilogue as little-endian u32 limb
    arrays, by `_scale_mode`:
      shoup: (W, ⌊W·2^64/p⌋, W2 = 2^64·W mod p, ⌊W2·2^64/p⌋) -> 8 arrays;
      gl:    (W,) -> 2 arrays;
      mont:  (W·2^64 mod p,) -> 2 arrays."""
    Wo = W.astype(object)

    def split(a):
        return (
            (a & 0xFFFFFFFF).astype(np.uint64).astype(np.uint32),
            (a >> 32).astype(np.uint64).astype(np.uint32),
        )

    mode = _scale_mode(p)
    if mode == "shoup":
        W2 = (Wo << 64) % p
        return split(Wo) + split((Wo << 64) // p) + split(W2) + split((W2 << 64) // p)
    if mode == "gl":
        return split(Wo)
    return split((Wo << 64) % p)


@lru_cache(maxsize=32)
def _tables(n: int, p: int):
    n1, n2 = four_step_factors(n)
    return _tables_from_ops(n1, n2, p, _operators(n, p))


def _tables_from_ops(n1: int, n2: int, p: int, ops: dict):
    """Host table dict (numpy) from an explicit operator set."""
    c64 = (1 << 64) % p
    n_lazy = _n_eplanes_lazy(p)
    tbl = {
        "n1": n1,
        "n2": n2,
        "p": p,
        "goldilocks": p == GOLDILOCKS,
        "c64": c64,
        "c64_shoup": (c64 << 64) // p,
        "p_neginv": mont_neginv64(p),
        "n_d": _n_dplanes(p),
        "scale_mode": _scale_mode(p),
        # A and G take raw u64 representatives (8 operand planes); F and
        # Ainv take the mid-pass outputs, < 4p in shoup mode (the plane diet)
        "A": _prep64(ops["A"].T, p, 8),
        "F": _prep64(ops["F"].T, p, n_lazy),
        "Ainv": _prep64(ops["Ainv"].T, p, n_lazy),
        "G": _prep64(ops["G"].T, p, 8),
        "d": _scale_tables64(ops["d"].T, p),  # fwd mid layout [n2, n1]
        "e": _scale_tables64(ops["e"], p),  # inv mid layout [n1, n2]
        "barrett": (1 << 64) // p,  # floor(2^64/p); quotient error <= 2
    }
    if p >= (1 << 63):
        tbl["c64_mont"] = (c64 << 64) % p  # Montgomery fold of the top limb
    return tbl


@lru_cache(maxsize=64)
def _scaled_ainv_planes(n: int, p: int, scale: int):
    """A_inv times a constant (n^-1 and a Montgomery factor folded into the
    last matmul)."""
    M = (_operators(n, p)["Ainv"].T.astype(object) * scale % p).astype(np.uint64)
    return _prep64(M, p, _n_eplanes_lazy(p))


@lru_cache(maxsize=32)
def _wide_col_planes(n: int, p: int, n_limbs: int):
    """Column-pass planes consuming u{32*n_limbs} limb tuples directly: the
    residue split (value mod p) folds into the matmul as 4 * n_limbs operand
    digit planes (16 for a u128 operand, contraction 16 * n1)."""
    return _prep64(_operators(n, p)["A"].T, p, 4 * n_limbs)


_SC_FIELDS = ("p", "c64", "c64_shoup", "p_neginv", "barrett", "two_p")
_SCAL_WORDS = 16


def _scal_vec64(n: int, p: int, tbl: dict | None = None) -> list[int]:
    """The channel grid's per-prime scalars as 12 u32 words (limb pairs of
    p, 2^64 mod p, its Shoup companion, -p^-1 mod 2^64, floor(2^64/p), 2p)."""
    if tbl is None:
        tbl = _tables(n, p)
    vals = (p, tbl["c64"], tbl["c64_shoup"], tbl["p_neginv"], tbl["barrett"], 2 * p)
    out = []
    for v in vals:
        out += [v & MASK32, (v >> 32) & MASK32]
    return out


def multi_applicable(n: int, primes) -> bool:
    """Whether the channel grid serves the prime set: the four-step range,
    every prime in the shoup regime, and one (matrix, operand) plane count
    for all (the stacked tables need uniform shapes)."""
    return (
        all(applicable(n, p) and p < (1 << 62) for p in primes)
        and len({(_n_dplanes(p), _n_eplanes_lazy(p)) for p in primes}) == 1
    )


@lru_cache(maxsize=16)
def _multi_tables64(n: int, primes: tuple, scales: tuple, hyb: int | None = None):
    """Stacked per-channel tables of the channel grid (numpy) for transforms
    of size n. With `hyb` = N, the size of a parent transform, they are the
    block tables of the stage-split hybrid (`ops/stagesplit.py`) for its
    nb = N // n blocks: what differs per block (A_b and d_b forward, e_b
    and A_inv,b times the scale inverse) gains a block axis after the
    channel's, [C, nb, ...]; F, G and the scalars stay per channel."""
    n1, n2 = four_step_factors(n)
    stk = lambda xs: np.ascontiguousarray(np.stack(xs, axis=0))
    if hyb is not None:
        from . import stagesplit

        per_block = lambda xs: stk(xs)  # [nb, ...]
    else:
        per_block = lambda xs: xs[0]
    p1f, c1f, p2f, c2f = [], [], [], []
    p1i, c1i, p2i, c2i = [], [], [], []
    dm, em, scal = [], [], []
    for ch, p in enumerate(primes):
        assert (1 << 33) < p < (1 << 62), "channel-grid tables need p in (2^33, 2^62)"
        sc = scales[ch] % p
        if hyb is None:
            blocks = (_tables(n, p),)
            ainv = (blocks[0]["Ainv"] if sc == 1 else _scaled_ainv_planes(n, p, sc),)
        else:
            blocks = stagesplit._dev64(hyb, p, n)["blocks"]
            ainv = (tuple(t["Ainv"] for t in blocks) if sc == 1
                    else stagesplit._scaled_ainv_blocks64(hyb, p, n, sc))
        tbl = blocks[0]  # F, G and the scalars are one for all blocks
        p1f.append(per_block([t["A"][0] for t in blocks]))
        c1f.append(per_block([t["A"][1] for t in blocks]))
        p2f.append(tbl["F"][0]); c2f.append(tbl["F"][1])
        p1i.append(tbl["G"][0]); c1i.append(tbl["G"][1])
        p2i.append(per_block([m[0] for m in ainv]))
        c2i.append(per_block([m[1] for m in ainv]))
        dm.append([per_block([t["d"][j] for t in blocks]) for j in range(len(tbl["d"]))])
        em.append([per_block([t["e"][j] for t in blocks]) for j in range(len(tbl["e"]))])
        scal.append(_scal_vec64(n, p, tbl) + [0] * (_SCAL_WORDS - 2 * len(_SC_FIELDS)))
    n_tab = len(dm[0])  # 8: the shoup regime's arrays
    return {
        "n1": n1, "n2": n2,
        "fwd": (stk(p1f), stk(c1f), stk(p2f), stk(c2f),
                tuple(stk([d[j] for d in dm]) for j in range(n_tab))),
        "inv": (stk(p1i), stk(c1i), stk(p2i), stk(c2i),
                tuple(stk([e[j] for e in em]) for j in range(n_tab))),
        "scalars": np.array(scal, dtype=np.uint32),  # [C, 16]
    }


# ---------------------------------------------------------------------------
# Device half: plain torch on int64 carriers
# ---------------------------------------------------------------------------


def _digit_cat(limbs: tuple, n_planes: int | None = None):
    """int8 digit planes (byte - 128) of the little-endian limb tuple,
    concatenated on the last axis. n_planes < 4·len(limbs) skips the top
    bytes: valid only where the value bound makes them zero (the F / Ainv
    mid-pass operands, `_n_eplanes_lazy`)."""
    if n_planes is None:
        n_planes = 4 * len(limbs)
    parts = [
        (((limbs[ee // 4] >> (8 * (ee % 4))) & 255) - 128).to(torch.int8)
        for ee in range(n_planes)
    ]
    return torch.cat(parts, dim=-1)


def _dot(xd, planes):
    """int8 digits [..., E*K] x planes [E*K, D*O] -> int32 [..., D*O]."""
    acc = int_mm(xd.reshape(-1, xd.shape[-1]), planes)
    return acc.reshape(*xd.shape[:-1], planes.shape[1])


def _combine8(big, cvec, o: int, n_d: int = 8):
    """int32 accumulators [..., D*O] -> the three u32 limbs of the exact
    value V = Σ_d U_d·2^(8d), U_d = acc_d + cvec_d in [0, 2^28), for D in
    [5, 9]. A ninth digit sits at bit 64 and adds into the third limb."""
    assert 5 <= n_d <= 9, n_d
    u = [
        (big[..., dd * o : (dd + 1) * o] + cvec[dd]).to(torch.int64) & MASK32
        for dd in range(n_d)
    ]
    low = u[0] + (u[1] << 8) + (u[2] << 16) + (u[3] << 24)  # exact: < 2^53
    mid = (low >> 32) + u[4]
    for idx, sh in zip(range(5, min(n_d, 8)), (8, 16, 24)):
        mid = mid + (u[idx] << sh)  # exact: < 2^53
    v2 = mid >> 32
    if n_d == 9:
        v2 = v2 + u[8]
    return low & MASK32, mid & MASK32, v2


def _fold3to2(v0, v1, v2, tbl):
    """(v0, v1, v2) -> a 64-bit limb-pair representative of the same residue."""
    p = tbl["p"]
    if tbl["goldilocks"]:
        # v2·2^64 ≡ v2·(2^32 - 1): t = (v2 << 32) - v2
        nz = (v2 != 0).to(torch.int64)
        t = ((-v2) & MASK32, (v2 - nz) & MASK32)
        s, carry = add64c((v0, v1), t)
        return add64(s, (carry * MASK32, 0))  # + carry·(2^32 - 1)
    c64 = const64_like(tbl["c64"])
    if p < (1 << 63):
        t = shoup_mul_u32_lazy64(v2, c64, const64_like(tbl["c64_shoup"]), p)  # [0, 2p)
    else:
        # p >= 2^63: Shoup's 2p bound passes 2^64; Montgomery-multiply the top
        # limb by 2^128 mod p instead
        t = mont_mul64((v2, torch.zeros_like(v2)), const64_like(tbl["c64_mont"]), p,
                       tbl["p_neginv"])
    s, carry = add64c((v0, v1), t)
    comp = (carry * c64[0], carry * c64[1])
    if 3 * p < (1 << 64):
        return add64(s, comp)  # wrapped s < 2p, + c64 < 3p < 2^64
    s, carry2 = add64c(s, comp)
    return add64(s, (carry2 * c64[0], carry2 * c64[1]))  # cannot wrap again


def _scale_mont(rep, mont_tab, tbl):
    """rep·W mod p as a lazy 64-bit representative (mont and gl modes);
    mont_tab = W·2^64 mod p (mont) or W (gl)."""
    if tbl["goldilocks"]:
        return gl_mul_lazy(rep, mont_tab)
    return mont_mul64(rep, mont_tab, tbl["p"], tbl["p_neginv"])


def _scaled_epilogue(v0, v1, v2, tab, tbl):
    """Three-limb V -> V·W mod p as a lazy limb pair; `tab` holds the
    diagonal's carrier tensors (`_scale_tables64` order)."""
    if tbl["scale_mode"] == "shoup":
        p = tbl["p"]
        t1 = shoup_mul_lazy64((v0, v1), (tab[0], tab[1]), (tab[2], tab[3]), p)
        t2 = shoup_mul_u32_lazy64(v2, (tab[4], tab[5]), (tab[6], tab[7]), p)
        return add64(t1, t2)  # < 4p < 2^64
    return _scale_mont(_fold3to2(v0, v1, v2, tbl), tab, tbl)


def _canonical(v0, v1, v2, tbl):
    """Three-limb V -> canonical V mod p as a limb pair."""
    p = tbl["p"]
    rep = _fold3to2(v0, v1, v2, tbl)
    if p >= (1 << 63):
        return cond_sub64(rep, p)  # rep < 2^64 < 2p
    if p >= (1 << 62):
        return cond_sub64(cond_sub64(rep, 2 * p), p)  # rep < 2^64 < 4p
    # approximate Barrett: q in [floor(rep/p) - 2, floor(rep/p)], so
    # rep - q·p < 3p < 2^64 and two conditional subtracts finish
    q = mulhi64(rep, const64_like(tbl["barrett"]))
    r = sub64(rep, mullo64(q, const64_like(p)))
    return cond_sub64(cond_sub64(r, 2 * p), p)


def _combined(limbs, mat):
    """The three-limb combine of limbs [..., K] against (planes, cvec)."""
    planes, cvec = mat
    if isinstance(planes, np.ndarray):
        planes, cvec = _dev(planes, limbs[0].device), _dev(cvec, limbs[0].device)
    n_d = cvec.shape[0]
    o = planes.shape[1] // n_d
    n_e = planes.shape[0] // limbs[0].shape[-1]  # operand planes (plane diet)
    return _combine8(_dot(_digit_cat(limbs, n_e), planes), cvec, o, n_d)


def _diag_dev(tab, device):
    return tuple(_dev(a, device) for a in tab)


def _matmod_scaled_lazy(limbs, mat, scale_tab, tbl):
    return _scaled_epilogue(*_combined(limbs, mat), _diag_dev(scale_tab, limbs[0].device), tbl)


def _matmod_canonical(limbs, mat, tbl):
    return _canonical(*_combined(limbs, mat), tbl)


def _t(pair):
    return tuple(a.transpose(1, 2) for a in pair)


def _fwd_core(limbs: tuple, tbl: dict, mat1=None):
    """Four-step forward of carrier limbs [B, n] against a table dict."""
    n1, n2 = tbl["n1"], tbl["n2"]
    b = limbs[0].shape[0]
    v = tuple(a.reshape(b, n1, n2).transpose(1, 2) for a in limbs)
    y = _matmod_scaled_lazy(v, tbl["A"] if mat1 is None else mat1, tbl["d"], tbl)  # [B, n2, n1]
    out = _matmod_canonical(_t(y), tbl["F"], tbl)  # [B, n1, n2]
    return tuple(a.reshape(b, n1 * n2) for a in out)


def _inv_core(limbs: tuple, tbl: dict, mat2=None):
    """Four-step inverse of carrier limbs [B, n] against a table dict."""
    n1, n2 = tbl["n1"], tbl["n2"]
    b = limbs[0].shape[0]
    v = tuple(a.reshape(b, n1, n2) for a in limbs)
    y = _matmod_scaled_lazy(v, tbl["G"], tbl["e"], tbl)  # [B, n1, n2] lazy
    out = _matmod_canonical(_t(y), tbl["Ainv"] if mat2 is None else mat2, tbl)  # [B, n2, n1]
    return tuple(a.transpose(1, 2).reshape(b, n1 * n2) for a in out)


def _pair_u32(pair):
    return tuple(to_u32(a) for a in pair)


def fwd(limbs: tuple, *, n: int, p: int):
    """Forward negacyclic NTT of (lo, hi) uint32 [B, n] (any u64 values) ->
    (lo, hi) canonical [0, p), bit-reversed order. Four limbs are a u128
    operand: its residue split folds into the column matmul."""
    mat1 = None if len(limbs) == 2 else _wide_col_planes(n, p, len(limbs))
    return _pair_u32(_fwd_core(tuple(to_i64(a) for a in limbs), _tables(n, p), mat1))


def inv(limbs: tuple, *, n: int, p: int, scale: int = 1):
    """Inverse negacyclic NTT (unnormalized; a non-unit scale is folded into
    A_inv): (lo, hi) uint32 [B, n], any u64 representatives, bit-reversed ->
    (lo, hi) canonical, standard order."""
    tbl = _tables(n, p)
    mat2 = tbl["Ainv"] if scale % p == 1 else _scaled_ainv_planes(n, p, scale % p)
    return _pair_u32(_inv_core(tuple(to_i64(a) for a in limbs), tbl, mat2))


def pass_mat(n: int, p: int, which: str, scale: int = 1):
    """(planes, cvec) of one pass: A, F, G, or Ainv (times `scale`)."""
    if which == "Ainv" and scale % p != 1:
        return _scaled_ainv_planes(n, p, scale % p)
    return _tables(n, p)[which]


def pass_plain(limbs: tuple, *, n: int, p: int, which: str, diag_slices=(), scale: int = 1):
    """One exact modular GEMM pass on (lo, hi) uint32 [B, rows, K] ->
    (lo, hi) [B, rows, O]: scaled-lazy against the given rows of the
    diagonal tables, or canonical without them."""
    tbl = _tables(n, p)
    trip = _combined(tuple(to_i64(a) for a in limbs), pass_mat(n, p, which, scale))
    if diag_slices:
        return _pair_u32(_scaled_epilogue(*trip, _diag_dev(diag_slices, limbs[0].device), tbl))
    return _pair_u32(_canonical(*trip, tbl))


# ---------------------------------------------------------------------------
# Channel-grid twins: the same algebra driven by the 16-word scalar record
# (shoup regime only), as the channel-grid kernels read it
# ---------------------------------------------------------------------------


def _read_sc(rec) -> dict:
    """Scalar record [16] (uint32 words) -> {field: Python int}."""
    words = [int(w) for w in rec]
    return {name: words[2 * j] | (words[2 * j + 1] << 32) for j, name in enumerate(_SC_FIELDS)}


def _sc_tbl(sc: dict) -> dict:
    assert sc["two_p"] == 2 * sc["p"] and sc["p"] < (1 << 62)
    return {"p": sc["p"], "goldilocks": False, "scale_mode": "shoup", "c64": sc["c64"],
            "c64_shoup": sc["c64_shoup"], "p_neginv": sc["p_neginv"], "barrett": sc["barrett"]}


def _sc_mont_mul64(a, b, sc: dict):
    """Montgomery product of two any-u64 limb pairs with (p, -p^-1) read
    from the scalar record; the overflow of the REDC sum is kept."""
    return mont_mul64(a, b, sc["p"], sc["p_neginv"])


def _sc_scaled_epilogue(v0, v1, v2, tab, sc: dict):
    return _scaled_epilogue(v0, v1, v2, tab, _sc_tbl(sc))


def _sc_canonical(v0, v1, v2, sc: dict):
    return _canonical(v0, v1, v2, _sc_tbl(sc))


def _multi_channel(limbs, tabs, direction: str, ch: int, blk: int = 0):
    """Channel `ch` of the channel grid on carrier limbs [B, n]: the
    four-step against the stacked tables and the scalar record; with hybrid
    tables (`_multi_tables64(..., hyb=N)`), block `blk` of that channel."""
    n1, n2 = tabs["n1"], tabs["n2"]
    planes1, cvec1, planes2, cvec2, diag = tabs[direction]
    sc = _read_sc(tabs["scalars"][ch])
    dev = limbs[0].device
    b = limbs[0].shape[0]
    fwd = direction == "fwd"
    blocked = diag[0].ndim == 4  # [C, nb, R, O]: hybrid block tables
    if fwd:
        v = tuple(a.reshape(b, n1, n2).transpose(1, 2) for a in limbs)
    else:
        v = tuple(a.reshape(b, n1, n2) for a in limbs)

    def pick(t, per_block):
        t = _dev(t, dev)[ch]
        return t[blk] if per_block and blocked else t

    tab = tuple(pick(t, True) for t in diag)
    mat1 = (pick(planes1, fwd), pick(cvec1, fwd))  # A_b per block, G shared
    mat2 = (pick(planes2, not fwd), pick(cvec2, not fwd))  # F shared, Ainv_b per block
    y = _sc_scaled_epilogue(*_combined(v, mat1), tab, sc)
    out = _sc_canonical(*_combined(_t(y), mat2), sc)
    if not fwd:
        out = _t(out)
    return tuple(a.reshape(b, n1 * n2) for a in out)
