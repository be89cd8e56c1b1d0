// Host-side table construction for the 64-bit four-step engine (ops/mxu64.py),
// compiled with the host C++ compiler at first use (ops/host_build.py) and
// called through ctypes. numpy's uint64 cannot hold a 64 x 64-bit product,
// and exact bigint arrays take seconds per prime at n = 2^14, so the two
// routines that multiply mod a 64-bit prime run here on unsigned __int128:
//
//   fourstep_build  the six four-step operators A, F, d, G, e, A_inv of
//                   (n, p, n1) from the negacyclic twiddle tables, with the
//                   row factorization checks of ops/mxu32.py's numpy version
//                   (F diag(d_r), diag(e_r) G);
//   prep_matrix     the balanced radix-256 int8 digit planes of a matrix
//                   mod p for E operand planes and D matrix planes, and the
//                   epilogue constants (ops/mxu32.py::_prep_matrix).
//
// Both give the JAX package's tables bit for bit (tests/test_torch_tables.py).

#include <cstdint>
#include <cstring>
#include <vector>

using u64 = uint64_t;
using u128 = unsigned __int128;
using i64 = int64_t;

static inline u64 mulmod(u64 a, u64 b, u64 p) { return (u64)(((u128)a * b) % p); }

// (a + b) mod p and (a - b) mod p for a, b in [0, p), any p < 2^64
static inline u64 addmod(u64 a, u64 b, u64 p) {
  const u64 s = a + b;
  if (s < a) return s - p;  // wrapped: the true sum is s + 2^64
  return s >= p ? s - p : s;
}

static inline u64 submod(u64 a, u64 b, u64 p) { return a >= b ? a - b : a - b + p; }

static u64 powmod(u64 a, u64 e, u64 p) {
  u64 r = 1 % p;
  a %= p;
  for (; e; e >>= 1) {
    if (e & 1) r = mulmod(r, a, p);
    a = mulmod(a, a, p);
  }
  return r;
}

// forward CT stages [s0, s1) on [rows, n] (block i of stage s uses twid[2^s + i])
static void fwd_stages(u64* data, i64 rows, i64 n, const u64* twid, u64 p, int s0, int s1) {
  for (int s = s0; s < s1; s++) {
    const i64 m = 1ll << s, t = n >> (s + 1);
    for (i64 r = 0; r < rows; r++)
      for (i64 i = 0; i < m; i++) {
        const u64 w = twid[m + i];
        u64* blk = data + r * n + i * 2 * t;
        for (i64 j = 0; j < t; j++) {
          const u64 z0 = blk[j], wz1 = mulmod(blk[j + t], w, p);
          blk[j] = addmod(z0, wz1, p);
          blk[j + t] = submod(z0, wz1, p);
        }
      }
  }
}

// inverse GS stages s_hi - 1 down to s_lo
static void inv_stages(u64* data, i64 rows, i64 n, const u64* inv_twid, u64 p, int s_hi,
                       int s_lo) {
  for (int s = s_hi - 1; s >= s_lo; s--) {
    const i64 m = 1ll << s, t = n >> (s + 1);
    for (i64 r = 0; r < rows; r++)
      for (i64 i = 0; i < m; i++) {
        const u64 w = inv_twid[m + i];
        u64* blk = data + r * n + i * 2 * t;
        for (i64 j = 0; j < t; j++) {
          const u64 z0 = blk[j], z1 = blk[j + t];
          blk[j] = addmod(z0, z1, p);
          blk[j + t] = mulmod(submod(z0, z1, p), w, p);
        }
      }
  }
}

// The column matrix M[n1][n1] of a stage range s < log2(n1): M[r][i] is the
// coefficient of input row i in output row r of any one column. Such stages
// pair index j with j + t for t a multiple of n2 and take their twiddle by
// the block index j / (2t), so column `col` of the [n1][n2] view never mixes
// with another and sees a size-n1 stage engine with the same twiddles,
// whatever col is: the stages run on the n1 x n1 identity (n1^2 log n1
// products, not n1 n log n1, and no n1 x n buffer at n = 2^17).
template <typename Stages>
static void col_matrix(u64* M, i64 n1, Stages run) {
  std::vector<u64> buf(n1 * n1, 0);
  for (i64 i = 0; i < n1; i++) buf[i * n1 + i] = 1;
  run(buf.data(), n1);
  for (i64 r = 0; r < n1; r++)
    for (i64 i = 0; i < n1; i++) M[r * n1 + i] = buf[i * n1 + r];
}

extern "C" {

// A[n1*n1], F[n2*n2], d[n1*n2], G[n2*n2], e[n1*n2], Ainv[n1*n1] from
// twid / inv_twid [n] (golden negacyclic_twiddles). 0 on success, else the
// number of the factorization check that failed.
int fourstep_build(u64 p, i64 n, i64 n1, const u64* twid, const u64* inv_twid, u64* A, u64* F,
                   u64* d, u64* G, u64* e, u64* Ainv) {
  const i64 n2 = n / n1;
  int k = 0, log2n = 0;
  while ((1ll << k) < n1) k++;
  while ((1ll << log2n) < n) log2n++;

  col_matrix(A, n1, [&](u64* b, i64 rows) { fwd_stages(b, rows, n1, twid, p, 0, k); });

  // B[j][r*n2 + kap] = (row r's operator)[kap][j], for fwd then inv
  std::vector<u64> B(n2 * n);
  auto basis = [&](auto run) {
    std::fill(B.begin(), B.end(), 0);
    for (i64 j = 0; j < n2; j++) {
      u64* row = B.data() + j * n;
      for (i64 r = 0; r < n1; r++) row[r * n2 + j] = 1;
      run(row);
    }
  };
  // forward rows: B_r = F diag(d_r)
  basis([&](u64* row) { fwd_stages(row, 1, n, twid, p, k, log2n); });
  for (i64 kap = 0; kap < n2; kap++)
    for (i64 j = 0; j < n2; j++) F[kap * n2 + j] = B[j * n + kap];
  for (i64 j = 0; j < n2; j++) {
    const u64 f0inv = powmod(F[j], p - 2, p);
    for (i64 r = 0; r < n1; r++) {
      const u64 dr = mulmod(B[j * n + r * n2], f0inv, p);
      d[r * n2 + j] = dr;
      for (i64 kap = 0; kap < n2; kap++)
        if (B[j * n + r * n2 + kap] != mulmod(F[kap * n2 + j], dr, p)) return 3;
    }
  }
  // inverse rows: C_r = diag(e_r) G
  basis([&](u64* row) { inv_stages(row, 1, n, inv_twid, p, log2n, k); });
  for (i64 kap = 0; kap < n2; kap++)
    for (i64 j = 0; j < n2; j++) G[kap * n2 + j] = B[j * n + kap];
  for (i64 kap = 0; kap < n2; kap++) {
    const u64 g0inv = powmod(G[kap * n2], p - 2, p);
    for (i64 r = 0; r < n1; r++) {
      const u64 er = mulmod(B[r * n2 + kap], g0inv, p);
      e[r * n2 + kap] = er;
      for (i64 j = 0; j < n2; j++)
        if (B[j * n + r * n2 + kap] != mulmod(er, G[kap * n2 + j], p)) return 4;
    }
  }

  col_matrix(Ainv, n1, [&](u64* b, i64 rows) { inv_stages(b, rows, n1, inv_twid, p, k, 0); });
  return 0;
}

// M[K*O] (mod p) -> planes[(E*K) * (D*O)] int8, cvec[D*O] int32: operand
// plane e holds M * 2^(8e) mod p, centred to (-p/2, p/2] and split into D
// balanced radix-256 digits; cvec_d = 128 * (column sum of digit d) + 2^27.
// 0 on success; 1 = D digits do not cover p/2; 2 = a constant passes 2^27.
int prep_matrix(const u64* M, i64 K, i64 O, u64 p, i64 E, i64 D, int8_t* planes, int32_t* cvec) {
  std::vector<i64> csum(D * O, 0);
  std::vector<u64> Me(M, M + K * O);
  for (i64 ee = 0; ee < E; ee++) {
    if (ee > 0)
      for (i64 t = 0; t < K * O; t++) Me[t] = (u64)(((u128)Me[t] << 8) % p);
    for (i64 kk = 0; kk < K; kk++)
      for (i64 oo = 0; oo < O; oo++) {
        const u64 raw = Me[kk * O + oo];  // compare in u64: p may pass 2^63
        i64 v = raw > p / 2 ? (i64)(raw - p) : (i64)raw;
        for (i64 dd = 0; dd < D; dd++) {
          const i64 r = ((v + 128) & 255) - 128;
          planes[(ee * K + kk) * (D * O) + dd * O + oo] = (int8_t)r;
          csum[dd * O + oo] += 128 * r;
          v = (v - r) >> 8;
        }
        if (v != 0) return 1;
      }
  }
  for (i64 t = 0; t < D * O; t++) {
    if (csum[t] <= -(1ll << 27) || csum[t] >= (1ll << 27)) return 2;
    cvec[t] = (int32_t)(csum[t] + (1ll << 27));
  }
  return 0;
}

}  // extern "C"
