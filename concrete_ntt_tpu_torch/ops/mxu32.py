"""Four-step prime32 NTT as two exact int8 modular matrix products.

Counterpart of `concrete_ntt_tpu/ops/mxu32.py`, in two halves:

  * **Host half, bit-for-bit copy (numpy).** The exact stage engine that
    builds the six four-step operators A, F, d, G, e, A_inv from the golden
    twiddles, the balanced-digit int8 plane packing with its epilogue
    constants (`_prep_matrix`, `off_delta`), the accumulator-exactness
    proof (`assert_accumulator_exact`, run on every table built) and the
    table dicts (`_mxu_tables`, `_wide_col_planes`, `_scaled_ainv_planes`).
    The port's tests assert every array equals the JAX package's.
  * **Device half, plain torch.** `_digit_cat`, `_dot_planes`
    (`torch._int_mm`), `_combine`, the two epilogues and the single-channel
    transforms `fwd`, `fwd_wide`, `inv(scale)`. This is the plain reference
    the channel-grid kernels of `ops/mxu32_cuda.py` are held against.

The algebra (why it is exact):

  * stages [0, k) of the reference's forward transform mix only rows of the
    [n1, n2] view, so they form ONE shared n1 x n1 matrix A applied to every
    column; stages [k, log2 n) act within rows, and row r's operator factors
    as F * diag(d_r) with a shared n2 x n2 matrix F. The inverse mirrors
    this: C_r = diag(e_r) * G, then the shared column matrix A_inv.
  * An operand x (any u32 representative) is split into four radix-2^8
    digit planes shifted to int8 by -128; the matrix M is pre-multiplied by
    2^(8e) mod p per operand digit e, centered to (-p/2, p/2] and
    balanced-digit decomposed into D int8 planes. The D int32 accumulators
    S_d stay exact, and sum_d S_d 2^(8d) is reduced with one Shoup
    high-multiply. The -128 shift and the sign offsets fold into per-output
    additive constants computed when the tables are built.

Reference parity anchors: stage structure fwd_breadth_first_scalar
(prime32/shoup.rs:582-636), inv (shoup.rs:1355-1408); twiddle tables
(prime32.rs:223-246).

Device-half carrier convention (ops/u32.py): u32 values are held in int64
tensors; the public transforms take and return uint32 tensors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..golden.ntt import negacyclic_twiddles
from .table_cache import cached_operators
from .u32 import (
    MASK32,
    add_mod,
    mont_mul,
    mont_neginv,
    shoup_mul_lazy,
    to_i64,
    to_u32,
)

# ---------------------------------------------------------------------------
# Host-side exact stage engine (numpy uint64) for building the matrices
# ---------------------------------------------------------------------------


def _fwd_stage_range(data: np.ndarray, twid: np.ndarray, p: int, s0: int, s1: int):
    """Run forward CT stages [s0, s1) on [rows, n] uint64 data (exact)."""
    rows, n = data.shape
    p64 = np.uint64(p)
    for s in range(s0, s1):
        m = 1 << s
        t = n >> (s + 1)
        v = data.reshape(rows, m, 2, t)
        z0 = v[:, :, 0, :].copy()
        z1 = v[:, :, 1, :]
        w = twid[m : 2 * m][None, :, None]
        wz1 = z1 * w % p64
        v[:, :, 0, :] = (z0 + wz1) % p64
        v[:, :, 1, :] = (z0 + p64 - wz1) % p64
    return data


def _inv_stage_range(data: np.ndarray, inv_twid: np.ndarray, p: int, s_hi: int, s_lo: int):
    """Run inverse GS stages s_hi-1 down to s_lo on [rows, n] uint64 data."""
    rows, n = data.shape
    p64 = np.uint64(p)
    for s in range(s_hi - 1, s_lo - 1, -1):
        m = 1 << s
        t = n >> (s + 1)
        v = data.reshape(rows, m, 2, t)
        z0 = v[:, :, 0, :].copy()
        z1 = v[:, :, 1, :]
        w = inv_twid[m : 2 * m][None, :, None]
        v[:, :, 0, :] = (z0 + z1) % p64
        v[:, :, 1, :] = (z0 + p64 - z1) % p64 * w % p64
    return data


def _col_matrix_fwd(n, n1, n2, twid, p):
    """A[n1, n1]: stages [0, k) as one matrix shared by all columns."""
    k = n1.bit_length() - 1
    basis = np.zeros((n1, n), dtype=np.uint64)
    for i in range(n1):
        basis[i, i * n2] = 1
        if n2 > 1:
            basis[i, i * n2 + 1] = 0  # placeholder; column-independence checked below
    out = _fwd_stage_range(basis, twid, p, 0, k)
    A = out[:, ::n2].T.copy()  # A[r, i]
    if n2 > 1:  # verify the operator is identical on a second column
        basis2 = np.zeros((n1, n), dtype=np.uint64)
        for i in range(n1):
            basis2[i, i * n2 + 1] = 1
        out2 = _fwd_stage_range(basis2, twid, p, 0, k)
        assert np.array_equal(out2[:, 1::n2].T, A), "column-dependence in stages [0,k)"
    return A


def _row_ops_fwd(n, n1, n2, twid, p):
    """F[n2, n2] shared row matrix + d[n1, n2] input-side diagonal:
    row r's stages-[k, log2n) operator is F @ diag(d[r])."""
    k = n1.bit_length() - 1
    log2n = n.bit_length() - 1
    # basis: row block r gets e_j in its row for all r at once
    B = np.zeros((n2, n1, n2), dtype=np.uint64)  # [j, r, kappa] = B_r[kappa, j]
    for j in range(n2):
        data = np.zeros((1, n), dtype=np.uint64)
        data[0].reshape(n1, n2)[:, j] = 1
        out = _fwd_stage_range(data, twid, p, k, log2n)
        B[j] = out[0].reshape(n1, n2)
    B = B.transpose(1, 2, 0)  # [r, kappa, j]
    F = B[0].copy()
    assert np.all(F != 0), "shared row matrix has zero entries"
    Finv = np.vectorize(lambda v: pow(int(v), p - 2, p), otypes=[object])(F)
    d = np.zeros((n1, n2), dtype=np.uint64)
    for r in range(n1):
        rat = (B[r].astype(object) * Finv) % p
        assert (rat == rat[0:1, :]).all(), "row operator does not factor as F.diag(d)"
        d[r] = rat[0].astype(np.uint64)
    return F, d


def _row_ops_inv(n, n1, n2, inv_twid, p):
    """G[n2, n2] shared inverse row matrix + e[n1, n2] OUTPUT-side diagonal:
    row r's inverse stages-[log2n, k) operator is diag(e[r]) @ G."""
    k = n1.bit_length() - 1
    log2n = n.bit_length() - 1
    C = np.zeros((n2, n1, n2), dtype=np.uint64)
    for j in range(n2):
        data = np.zeros((1, n), dtype=np.uint64)
        data[0].reshape(n1, n2)[:, j] = 1
        out = _inv_stage_range(data, inv_twid, p, log2n, k)
        C[j] = out[0].reshape(n1, n2)
    C = C.transpose(1, 2, 0)  # [r, kappa, j]
    G = C[0].copy()
    assert np.all(G != 0), "shared inverse row matrix has zero entries"
    Ginv = np.vectorize(lambda v: pow(int(v), p - 2, p), otypes=[object])(G)
    e = np.zeros((n1, n2), dtype=np.uint64)
    for r in range(n1):
        rat = (C[r].astype(object) * Ginv) % p
        assert (rat == rat[:, 0:1]).all(), "inverse row op does not factor as diag(e).G"
        e[r] = rat[:, 0].astype(np.uint64)
    return G, e


def _col_matrix_inv(n, n1, n2, inv_twid, p):
    """A_inv[n1, n1]: inverse stages [k, 0) as one shared column matrix."""
    k = n1.bit_length() - 1
    basis = np.zeros((n1, n), dtype=np.uint64)
    for i in range(n1):
        basis[i, i * n2] = 1
    out = _inv_stage_range(basis, inv_twid, p, k, 0)
    A = out[:, ::n2].T.copy()
    if n2 > 1:
        basis2 = np.zeros((n1, n), dtype=np.uint64)
        for i in range(n1):
            basis2[i, i * n2 + 1] = 1
        out2 = _inv_stage_range(basis2, inv_twid, p, k, 0)
        assert np.array_equal(out2[:, 1::n2].T, A), "column-dependence in inv stages"
    return A


# ---------------------------------------------------------------------------
# int8 digit-plane preparation (host)
# ---------------------------------------------------------------------------


def four_step_factors(n: int) -> tuple[int, int]:
    """The canonical four-step split n = n1·n2 (n1 = 2^(log2n//2)) — the
    ONE definition every table builder and kernel index map must share
    (here: ops/mxu32.py and the kernels of ops/mxu32_cuda.py)."""
    log2n = n.bit_length() - 1
    n1 = 1 << (log2n // 2)
    return n1, n // n1


def _n_dplanes32(p: int) -> int:
    """Matrix digit planes: centered entries |v| <= p/2 need 4 balanced
    radix-256 digits while p/2 <= 127*(256^4-1)/255, else 5 (primes near
    2^32, e.g. the reference's generic-regime bench prime 4293918721)."""
    return 4 if p // 2 <= 127 * ((1 << 32) - 1) // 255 else 5


def _balanced_digits(v: np.ndarray, n_d: int = 4) -> np.ndarray:
    """[n_d, ...] balanced radix-256 digits of centered int64 values."""
    digits = np.zeros((n_d,) + v.shape, dtype=np.int64)
    rem = v.astype(np.int64).copy()
    for dd in range(n_d):
        r = ((rem + 128) & 255) - 128
        digits[dd] = r
        rem = (rem - r) >> 8
    assert (rem == 0).all(), "balanced digit overflow"
    return digits


def _prep_matrix(M: np.ndarray, p: int, n_eplanes: int = 4, n_d: int = 4):
    """Pack M[K, O] (mod p) into fused int8 planes + epilogue constants.

    Returns (planes [E*K, D*O] int8 — ONE fused matmul computes all D
    matrix-digit accumulators S_d as O-wide column blocks —, cvec [D, O]
    int32 additive constants incl. the sign offsets).

    E = n_eplanes is the number of radix-2^8 digit planes of the OPERAND:
    4 for u32 inputs, 8 for u64 limb-pair inputs, 16 for u128 — the residue
    reduction of wide operands is linear mod p, so it folds into the matmul
    (the matmul answer to the reference's per-coefficient `% p` residue split,
    native64.rs:980-993).
    """
    K, O = M.shape
    Ms = [(M.astype(object) * (1 << (8 * ee))) % p for ee in range(n_eplanes)]
    # centered representative -> |entries| <= p/2, n_d balanced digits
    planes = np.zeros((n_eplanes * K, n_d * O), dtype=np.int8)
    csum = np.zeros((n_d, O), dtype=np.int64)
    for ee in range(n_eplanes):
        Mc = np.array(
            [[int(v) - p if int(v) > p // 2 else int(v) for v in row] for row in Ms[ee]],
            dtype=np.int64,
        )
        dig = _balanced_digits(Mc, n_d)  # [n_d, K, O]
        for dd in range(n_d):
            planes[ee * K : (ee + 1) * K, dd * O : (dd + 1) * O] = dig[dd].astype(
                np.int8
            )
            csum[dd] += 128 * dig[dd].sum(axis=0)  # the x(+128) shift correction
    cvec = csum + (1 << 27)  # sign offset making U_d nonnegative on device
    assert np.all(np.abs(csum) < (1 << 27)), "epilogue constant overflow"
    assert cvec.min() >= 0 and cvec.max() < (1 << 28)
    return planes, cvec.astype(np.int32)


def _reduce_chain(p: int) -> tuple[int, ...]:
    """Multiples of p to conditionally subtract to bring a u32 into [0, p)."""
    chain = []
    bound = (1 << 32) - 1
    while bound >= p:
        q = p
        while q * 2 <= bound and q * 2 < (1 << 32):
            q *= 2
        chain.append(q)
        bound = max(q - 1, bound - q)
    return tuple(chain)


@lru_cache(maxsize=64)
def _operators(n: int, p: int):
    """The six four-step operators A, F, d, G, e, Ainv (uint64 mod p).

    The JAX package's numpy builder, disk-cached across processes
    (ops/table_cache.py)."""
    return cached_operators(n, p, lambda: _build_operators(n, p))


def _build_operators(n: int, p: int):
    n1, n2 = four_step_factors(n)
    twid_t, inv_twid_t = negacyclic_twiddles(p, n)
    twid = np.array(twid_t, dtype=np.uint64)
    inv_twid = np.array(inv_twid_t, dtype=np.uint64)
    A = _col_matrix_fwd(n, n1, n2, twid, p)
    F, d = _row_ops_fwd(n, n1, n2, twid, p)
    G, e = _row_ops_inv(n, n1, n2, inv_twid, p)
    Ainv = _col_matrix_inv(n, n1, n2, inv_twid, p)
    return {"A": A, "F": F, "d": d, "G": G, "e": e, "Ainv": Ainv}


def assert_accumulator_exact(planes: np.ndarray, cvec: np.ndarray):
    """Worst-case proof that the int8 matmul epilogue cannot wrap.

    The device computes U_d = (xd @ planes)[.., d*O:(d+1)*O] + cvec[d] and
    casts to uint32, relying on U_d in [0, 2^28). With operand digits in
    [-128, 127], |acc per column| <= 128 * sum(|plane column|), so it
    suffices that 128*colsum + |csum| < 2^27 for every output column
    (csum = cvec - 2^27). This catches any unsafe (n, p, E) combination at
    table-build time instead of silently wrapping (e.g. contraction extents
    E*K > 4096 at very large n)."""
    n_d, O = cvec.shape
    colsum = np.abs(planes.astype(np.int64)).sum(axis=0).reshape(n_d, O)
    csum = cvec.astype(np.int64) - (1 << 27)
    worst = 128 * colsum + np.abs(csum)
    assert worst.max() < (1 << 27), (
        f"int8 accumulator may wrap: worst-case |U_d - 2^27| = {worst.max()}"
        f" >= 2^27 (contraction extent {planes.shape[0]})"
    )


def off_delta(p: int, n_d: int) -> np.ndarray:
    """Per-digit additive corrections making the sign offset vanish mod p.

    The device computes V = Σ_d U_d·2^(8d) with U_d = S_d + csum_d + 2^27,
    i.e. V = true + OFF with OFF = Σ_d 2^27·2^(8d). Instead of subtracting
    OFF·(scale) in every epilogue, shift the offset to a multiple of p:
    pick δ = the balanced radix-256 digits of the CENTERED (−OFF) mod p
    (|centered| ≤ p/2, which n_d digits cover by the _n_dplanes criterion)
    and add δ_d into cvec_d — then Σ_d (2^27+δ_d)·2^(8d) ≡ 0 (mod p) and V
    is directly a representative of the true result. |δ_d| ≤ 128 perturbs
    the U_d ∈ [0, 2^28) bound negligibly (re-asserted on the adjusted
    cvec by assert_accumulator_exact)."""
    off = sum((1 << 27) << (8 * dd) for dd in range(n_d))
    r = (-off) % p
    if r > p // 2:
        r -= p  # centered representative of (−OFF) mod p
    delta = np.zeros(n_d, dtype=np.int64)
    rem = int(r)
    for dd in range(n_d):
        dig = ((rem + 128) & 255) - 128
        delta[dd] = dig
        rem = (rem - dig) >> 8
    assert rem == 0, "off_delta digits overflow (violates _n_dplanes bound)"
    return delta


def _prep(M: np.ndarray, p: int, n_eplanes: int = 4):
    """Digit-plane packing. cvec is adjusted by off_delta so the sign offset
    is ≡ 0 mod p."""
    n_d = _n_dplanes32(p)
    planes, cvec = _prep_matrix(np.ascontiguousarray(M), p, n_eplanes, n_d)
    cvec = (cvec.astype(np.int64) + off_delta(p, n_d)[:, None]).astype(np.int32)
    out = (planes, cvec)
    assert_accumulator_exact(*out)
    return out


@lru_cache(maxsize=64)
def _mxu_tables(n: int, p: int):
    n1, n2 = four_step_factors(n)
    return _mxu_tables_from_ops(n1, n2, p, _operators(n, p))


def _mxu_tables_from_ops(n1: int, n2: int, p: int, ops: dict):
    """Host table dict (numpy) from an explicit operator set."""
    A, F, d = ops["A"], ops["F"], ops["d"]
    G, e, Ainv = ops["G"], ops["e"], ops["Ainv"]

    def shoup(tbl):
        return ((tbl.astype(object) << 32) // p).astype(np.uint64).astype(np.uint32)

    c32 = (1 << 32) % p
    c32_shoup = (c32 << 32) // p

    tables = {
        "n1": n1,
        "n2": n2,
        "c32": np.uint32(c32),
        "c32_shoup": np.uint32(c32_shoup),
        "chain": _reduce_chain(p),
        "lazy4": 4 * p < (1 << 32),  # a+b of two [0,2p) values fits u32
        # p >= 2^31: Shoup's [0, 2p) lazy bound overflows u32, so the
        # epilogues switch to Montgomery multiplies (canonical outputs) —
        # the tier covering the reference's fully-generic prime32 engine
        # (prime32/generic.rs:59-226, Lemire lanes there).
        "mont_regime": p >= (1 << 31),
        "p_neginv": mont_neginv(p),
        "c64_mont": np.uint32((1 << 64) % p),  # mont_mul(hi, ·) = hi*2^32 mod p
    }
    # _matmod computes x @ planes (contraction over the input index), while the
    # operators are defined as out[r] = sum_i M[r, i] x[i] — store M transposed.
    # The sign offset is folded to ≡ 0 mod p inside _prep (off_delta), so no
    # epilogue ever corrects for it.
    for name, M in (("A", A.T), ("F", F.T), ("G", G.T), ("Ainv", Ainv.T)):
        planes, cvec = _prep(M, p)
        tables[name] = (planes, cvec)

    def scale_tabs(W):
        """Tables for the fused lazy scale-by-W epilogue: result represents
        V*W mod p given limbs (lo, hi) of V: lo*W + hi*(2^32 W).
        Shoup pairs for p < 2^31; Montgomery'd multiplicands (W*2^32 mod p,
        W*2^64 mod p) for the generic p >= 2^31 regime."""
        W = W.astype(object)
        W32 = (W << 32) % p
        u32a = lambda a: a.astype(np.uint64).astype(np.uint32)
        if p >= (1 << 31):
            return (u32a(W32), u32a((W << 64) % p))
        return (
            u32a(W),
            shoup(W.astype(np.uint64)),
            u32a(W32),
            shoup(W32.astype(np.uint64)),
        )

    tables["d"] = scale_tabs(d.T)  # fwd mid-pass layout [n2, n1]
    tables["e"] = scale_tabs(e)  # inv mid-pass layout [n1, n2]
    return tables


@lru_cache(maxsize=128)
def _wide_col_planes(n: int, p: int, n_limbs: int):
    """Column-pass planes consuming u{32*n_limbs} limb tuples directly: the
    residue split (value mod p) folds into the matmul as extra digit planes."""
    A = _operators(n, p)["A"]
    return _prep(A.T, p, n_eplanes=4 * n_limbs)


@lru_cache(maxsize=128)
def _scaled_ainv_planes(n: int, p: int, scale: int):
    """A_inv pre-multiplied by a constant (e.g. n^-1 * 2^32 mod p, folding the
    normalization and a Montgomery factor of the pointwise product into the
    final matmul — the matmul analogue of the reference's fused
    mul_assign_normalize, prime32.rs:812-864)."""
    Ainv = _operators(n, p)["Ainv"]
    M = (Ainv.T.astype(object) * scale % p).astype(np.uint64)
    return _prep(M, p)


# ---------------------------------------------------------------------------
# Device half: exact modular matmul + transform entry points (plain torch)
# ---------------------------------------------------------------------------

_DEV_TABLES: dict = {}


def _dev(arr: np.ndarray, device) -> torch.Tensor:
    """A host table as a tensor on `device`, memoized per (array, device).

    uint32 tables become int64 carriers (ops/u32.py); int8 planes and int32
    cvec keep their dtype. The host array is kept alive beside its copy, so
    its id cannot be reused while the entry exists."""
    key = (id(arr), str(device))
    hit = _DEV_TABLES.get(key)
    if hit is None or hit[0] is not arr:
        host = arr.astype(np.int64) if arr.dtype == np.uint32 else arr
        hit = (arr, torch.from_numpy(np.ascontiguousarray(host)).to(device))
        _DEV_TABLES[key] = hit
    return hit[1]


def _digit_cat(x):
    """int8 digit planes (value - 128) of x, concatenated along the last axis.

    x is a u32 carrier [..., K] (4 planes) or a little-endian limb tuple
    (lo, hi, ...) of such (4 planes per limb, limb-major order matching the
    2^(8e) weights of the wide matrix planes)."""
    limbs = x if isinstance(x, tuple) else (x,)
    parts = [
        (((limb >> (8 * ee)) & 255) - 128).to(torch.int8)
        for limb in limbs
        for ee in range(4)
    ]
    return torch.cat(parts, dim=-1)


def _dot_planes(x, mat):
    """Fused int8 digit dot contracting the LAST axis: u32 carrier (or limb
    tuple) [..., K] -> int32 accumulators [..., D*O]."""
    xd = _digit_cat(x)
    planes = _dev(mat[0], xd.device)
    acc = torch._int_mm(xd.reshape(-1, xd.shape[-1]), planes)
    return acc.reshape(*xd.shape[:-1], planes.shape[1])


def _combine(big, mat):
    """int32 accumulators [..., D*O] -> (lo, hi) u32 limbs of
    V = (x @ M mod p) + OFF (exact). D = 4 matrix digit planes for most
    primes; a 5th (sitting exactly at bit 32 → added into hi) for primes
    near 2^32 (_n_dplanes32)."""
    cvec = _dev(mat[1], big.device)
    n_d = cvec.shape[0]
    o = cvec.shape[1]
    u = [
        (big[..., dd * o : (dd + 1) * o] + cvec[dd]).to(torch.int64) & MASK32
        for dd in range(n_d)
    ]
    v = u[0] + (u[1] << 8) + (u[2] << 16) + (u[3] << 24)  # exact: < 2^57
    lo = v & MASK32
    hi = v >> 32
    if n_d == 5:
        hi = hi + u[4]  # digit 4 sits at bit 32 exactly
    return lo, hi & MASK32


def _reduce_u32(x, chain):
    for q in chain:
        x = torch.where(x >= q, x - q, x)
    return x


def _epilogue_canonical(lo, hi, tbl, *, p: int):
    """(lo, hi) limbs of V (≡ true mod p; the sign offset is folded into
    cvec via off_delta) -> canonical true mod p in [0, p)."""
    if tbl["mont_regime"]:
        # hi*(2^64 mod p)*2^-32 = hi*2^32 mod p, canonical for any odd p
        r = mont_mul(hi, int(tbl["c64_mont"]), p, tbl["p_neginv"])
    else:
        r = shoup_mul_lazy(hi, int(tbl["c32"]), int(tbl["c32_shoup"]), p)  # [0, 2p)
        r = torch.where(r >= p, r - p, r)
    lo = _reduce_u32(lo, tbl["chain"])
    if tbl["mont_regime"]:
        return add_mod(r, lo, p)
    s = r + lo
    return torch.where(s >= p, s - p, s)


def _epilogue_scaled_lazy(lo, hi, scale, tbl, *, p: int):
    """(lo, hi) limbs of V (≡ true mod p) -> true*W mod p as ANY u32
    representative: lo*W + hi*(2^32 W) via two Shoup multiplies (p < 2^31)
    or two Montgomery multiplies (generic p >= 2^31, where the Shoup
    [0, 2p) bound overflows u32; outputs canonical instead of lazy)."""
    if tbl["mont_regime"]:
        w32m, w64m = (_dev(t, lo.device) for t in scale)
        ninv = tbl["p_neginv"]
        a = mont_mul(lo, w32m, p, ninv)  # lo*W mod p, canonical
        b = mont_mul(hi, w64m, p, ninv)  # hi*2^32*W mod p, canonical
        return add_mod(a, b, p)
    w, w_sh, w32, w32_sh = (_dev(t, lo.device) for t in scale)
    a = shoup_mul_lazy(lo, w, w_sh, p)  # [0, 2p)
    b = shoup_mul_lazy(hi, w32, w32_sh, p)  # [0, 2p)
    if tbl["lazy4"]:
        s = a + b  # < 4p < 2^32: valid u32 representative
        return torch.where(s >= 2 * p, s - 2 * p, s)
    a = torch.where(a >= p, a - p, a)
    b = torch.where(b >= p, b - p, b)
    s = a + b  # < 2p < 2^32
    return torch.where(s >= p, s - p, s)


def _matmod(x, mat, tbl, *, p: int):
    """Exact canonical (x @ M) mod p in [0, p), contracting the LAST axis."""
    lo, hi = _combine(_dot_planes(x, mat), mat)
    return _epilogue_canonical(lo, hi, tbl, p=p)


def _matmod_scaled_lazy(x, mat, scale, tbl, *, p: int):
    """(x @ M)*W mod p as ANY u32 representative (lazy), contracting the
    last axis — the four-step twiddle correction fused into the reduction."""
    lo, hi = _combine(_dot_planes(x, mat), mat)
    return _epilogue_scaled_lazy(lo, hi, scale, tbl, p=p)


def _fwd_core(limbs: tuple, tbl, mat1, *, p: int):
    """Four-step forward of u32-carrier limbs [B, n] against a table dict."""
    n1, n2 = tbl["n1"], tbl["n2"]
    b = limbs[0].shape[0]
    v = tuple(a.reshape(b, n1, n2).transpose(1, 2) for a in limbs)  # [B, n2, n1]
    # column pass + fused twiddle correction: contract n1 -> [B, n2, n1]
    y = _matmod_scaled_lazy(v if len(v) > 1 else v[0], mat1, tbl["d"], tbl, p=p)
    y = y.transpose(1, 2)  # [B, n1, n2]
    # row pass: contract n2 -> [B, n1, n2], canonical
    out = _matmod(y, tbl["F"], tbl, p=p)
    return out.reshape(b, n1 * n2)


def _inv_core(x, tbl, mat2, *, p: int):
    """Four-step inverse of a u32 carrier [B, n] against a table dict."""
    n1, n2 = tbl["n1"], tbl["n2"]
    b = x.shape[0]
    v = x.reshape(b, n1, n2)
    # row pass + fused output diagonal: contract n2 -> [B, n1, n2]
    y = _matmod_scaled_lazy(v, tbl["G"], tbl["e"], tbl, p=p)
    y = y.transpose(1, 2)  # [B, n2, n1]
    # column pass: contract n1 -> [B, n2, n1], canonical
    out = _matmod(y, mat2, tbl, p=p)
    return out.transpose(1, 2).reshape(b, n1 * n2)


def fwd(x, *, n: int, p: int):
    """[B, n] uint32 -> forward negacyclic NTT, bit-reversed order, [0, p)."""
    tbl = _mxu_tables(n, p)
    return to_u32(_fwd_core((to_i64(x),), tbl, tbl["A"], p=p))


def fwd_wide(limbs: tuple, *, n: int, p: int):
    """Forward NTT of wide unsigned values given as little-endian uint32 limb
    tuples (each [B, n]): the residue split (value mod p) is folded into the
    column matmul as extra operand digit planes (native64.rs:980-993)."""
    tbl = _mxu_tables(n, p)
    mat1 = _wide_col_planes(n, p, len(limbs))
    return to_u32(_fwd_core(tuple(to_i64(a) for a in limbs), tbl, mat1, p=p))


def inv(x, *, n: int, p: int, scale: int = 1):
    """[B, n] uint32 bit-reversed NTT values -> standard order, [0, p).

    Unnormalized for scale=1 (inv(fwd(x)) == n*x); a non-unit scale
    multiplies every output by the constant, folded into the column
    matrix."""
    tbl = _mxu_tables(n, p)
    mat = tbl["Ainv"] if scale == 1 else _scaled_ainv_planes(n, p, scale % p)
    return to_u32(_inv_core(to_i64(x), tbl, mat, p=p))

