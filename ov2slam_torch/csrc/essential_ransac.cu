// Essential-matrix RANSAC (Nister 5-point samples plus an 8-point pool,
// Sampson-scored together), three launches per call.
//
// Replaces the XLA-compiled form of ov2slam_tpu/geometry/essential.py:385
// essential_ransac (five_point :299, _real_roots_deg10 :261, eight_point
// :70, sampson_dist_sq :53), which the JAX package fuses into its jitted
// tracking step. No Pallas kernel stands behind it. The plain PyTorch
// version is geometry/essential.py::essential_ransac_plain; this file
// computes what it computes:
//
//   ransac_hypotheses_kernel (one warp per sample):
//   - 5-point: the null space of the 5x9 system from a Householder QR of
//     its transpose in LAPACK's convention (geqr2: beta = -sign(alpha)
//     * |x|, tau = (beta - alpha) / beta; the complete Q's columns 5..8 as
//     org2r forms them, H(4) first), the 10x20 Nister constraint rows from
//     the same monomial tables as the plain version (_T112, _T213), the
//     10x10 system solved by LU with partial pivoting (getf2: the first
//     largest pivot, multipliers by the reciprocal, rank-1 updates; getrs
//     on the 10 right-hand sides), the degree-10 det B(z), its real roots
//     from the first 10 sign changes in grid order of cos^10(t) p(tan t) on
//     the plain version's 512-point grid (passed in, torch.linspace's own
//     values), 60 bisection steps in t and the |z| < 1e6 gate, then x and
//     y from B(z), E normalised; NaN in slots without a root.
//   - 8-point: the null vector of the 8x9 system (the same QR, column 8),
//     then the rank-2 projection through the eigenvectors of E^T E
//     (cyclic Jacobi on the 3x3 in registers, eigenvalues sorted
//     ascending; the plain version's 3x3 eigh).
//   ransac_score_kernel (one CTA per candidate): the Sampson distance of every
//     row, inlier = d2 < th & valid, quality = sum over inliers of
//     1 - d2/th; -1 for a candidate that is not ok (a sample row invalid, no
//     root) or not finite.
//   ransac_select_kernel (one CTA): argmax of quality with torch.argmax's rule
//     (the first index of the largest value; NaN largest), from a u64
//     packed as (order-preserving quality bits, ~index); then the winner's
//     E (zero where not finite), its inlier mask and count.
//
// Rounding. Sums run in a fixed order (each thread's rows in index order,
// then a xor butterfly of shuffles and the warps in order; no atomics), so
// two launches agree bit for bit. Against the plain version the small
// linear algebra rounds in another order (its QR, LU and eigh are
// LAPACK's or cuSOLVER's), so candidates agree to round-off; the Sampson
// distance uses the same expression in both the score and the selection
// kernel (explicit _rn intrinsics, no contraction), so the winner's mask
// is the one its quality was summed over. Never build with
// --use_fast_math.
//
// Bound on an H100 SXM. At the front end's call (N = 512 rows, 100
// 5-point and 25 8-point samples, 1025 candidates) the scoring is ~36
// FLOP a row and scored candidate, a 5-point sample ~10 kFLOP before its
// roots and 512 grid evaluations of ~55 FLOP, each root 61 more: ~14 MFLOP
// at slice B's data, 0.0002 ms at 67 TFLOP/s; the bytes (rows, samples,
// grid, E and the mask) ~17 KB (roofline.py::essential_ransac_bound).
// Neither binds: a sample's QR, LU and 60 bisection steps are a dependent
// chain on one warp, and a call takes about what one sample's does.
//
// Design. Simple first: one warp a sample keeps the small matrices in
// shared memory, the lanes split the columns of each QR and LU step, the
// grid evaluations (16 a lane) and the roots (one a lane); the scoring is
// a CTA a candidate over the rows, the selection one CTA. wgmma does not
// apply: the matrices are 10x20 at most and the work is a chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGrid = 512;        // the root search's grid (essential.py)
constexpr int kMaxRoots = 10;
constexpr int kBisect = 60;
constexpr int kScoreThreads = 128;
constexpr int kSelectThreads = 256;

// monomial products: deg1 x deg1 -> deg2 and deg2 x deg1 -> deg3 indices
// (essential.py's _T112, _T213 as index tables)
__constant__ int8_t kT112[4][4] = {
    {0, 1, 3, 6}, {1, 2, 4, 7}, {3, 4, 5, 8}, {6, 7, 8, 9}};
__constant__ int8_t kT213[10][4] = {
    {0, 2, 4, 5},   {2, 3, 8, 9},    {3, 1, 6, 7},    {4, 8, 10, 11},
    {8, 6, 13, 14}, {10, 13, 16, 17}, {5, 9, 11, 12}, {9, 7, 14, 15},
    {11, 14, 17, 18}, {12, 15, 18, 19}};

struct Sample {
  float a[8][9];        // A^T by columns (a sample row each), then the QR
  float tau[8];
  float null_[4][9];    // null-space columns of Q (X, Y, Z, W / e)
  float ep[9][4];       // E's entries as deg-1 polynomials in (x, y, z, 1)
  float c[9][10];       // C[i][k] = sum_m Ep[i][m] Ep[k][m], deg 2
  float m[10][20];      // constraint rows; after the solve, P in 10..19
  float bp[3][3][5];    // B(z): rows (4,5), (6,7), (8,9) of P
  float detb[11];
  int8_t sgn[kGrid];
  int roots[kMaxRoots];
  int n_roots;
  int ok;
};

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// cos^10(t) p(tan t) for lowest-first coefficients c: the plain version's
// s^k and co^(10-k) by repeated products, then the sum over k
__device__ float poly_tan_eval(const float* c, float t) {
  float s, co;
  sincosf(t, &s, &co);
  float sk[11], ck[11];
  sk[0] = 1.f;
  ck[0] = 1.f;
#pragma unroll
  for (int k = 1; k <= 10; ++k) {
    sk[k] = __fmul_rn(sk[k - 1], s);
    ck[k] = __fmul_rn(ck[k - 1], co);
  }
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k <= 10; ++k)
    acc = __fmaf_rn(c[k], __fmul_rn(sk[k], ck[10 - k]), acc);
  return acc;
}

// Householder QR of the 9 x k matrix sh.a (k = 5 or 8 columns) in
// LAPACK's geqr2 convention; the lanes split each reflector's columns
__device__ void householder_qr(Sample& sh, int k, int lane) {
  for (int i = 0; i < k; ++i) {
    if (lane == 0) {
      float* col = sh.a[i];
      const float alpha = col[i];
      float xn2 = 0.f;
      for (int r = i + 1; r < 9; ++r) xn2 = __fmaf_rn(col[r], col[r], xn2);
      if (xn2 == 0.f) {
        sh.tau[i] = 0.f;
      } else {
        const float norm = sqrtf(__fmaf_rn(alpha, alpha, xn2));
        const float beta = alpha >= 0.f ? -norm : norm;
        sh.tau[i] = __fdiv_rn(__fsub_rn(beta, alpha), beta);
        const float scal = __frcp_rn(__fsub_rn(alpha, beta));
        for (int r = i + 1; r < 9; ++r) col[r] = __fmul_rn(col[r], scal);
        col[i] = beta;
      }
    }
    __syncwarp();
    // apply H(i) = I - tau v v^T (v = [1, a[i][i+1..8]]) to columns > i
    const int j = lane;
    if (j > i && j < k && sh.tau[i] != 0.f) {
      const float* v = sh.a[i];
      float* cj = sh.a[j];
      float w = cj[i];
      for (int r = i + 1; r < 9; ++r) w = __fmaf_rn(cj[r], v[r], w);
      const float t = -__fmul_rn(sh.tau[i], w);
      cj[i] = __fadd_rn(cj[i], t);
      for (int r = i + 1; r < 9; ++r) cj[r] = __fmaf_rn(v[r], t, cj[r]);
    }
    __syncwarp();
  }
}

// column j (k <= j < 9) of the complete Q = H(0) ... H(k-1), as org2r forms
// it: e_j with H(k-1) applied first
__device__ void q_column(const Sample& sh, int k, int j, float* y) {
  for (int r = 0; r < 9; ++r) y[r] = r == j ? 1.f : 0.f;
  for (int i = k - 1; i >= 0; --i) {
    const float tau = sh.tau[i];
    if (tau == 0.f) continue;
    const float* v = sh.a[i];
    float w = y[i];
    for (int r = i + 1; r < 9; ++r) w = __fmaf_rn(y[r], v[r], w);
    const float t = -__fmul_rn(tau, w);
    y[i] = __fadd_rn(y[i], t);
    for (int r = i + 1; r < 9; ++r) y[r] = __fmaf_rn(v[r], t, y[r]);
  }
}

__device__ void p11(const float* a, const float* b, float* out) {
  for (int t = 0; t < 10; ++t) out[t] = 0.f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      out[kT112[i][j]] = __fmaf_rn(a[i], b[j], out[kT112[i][j]]);
}

// out += s * p21(a, b) (deg2 x deg1 -> deg3)
__device__ void p21_acc(const float* a, const float* b, float s,
                        float* out) {
  float t[20];
  for (int q = 0; q < 20; ++q) t[q] = 0.f;
  for (int i = 0; i < 10; ++i)
    for (int j = 0; j < 4; ++j)
      t[kT213[i][j]] = __fmaf_rn(a[i], b[j], t[kT213[i][j]]);
  for (int q = 0; q < 20; ++q) out[q] = __fmaf_rn(s, t[q], out[q]);
}

// polynomial product truncated to 11 coefficients: out += s * a * b
__device__ void conv_acc(const float* a, int la, const float* b, int lb,
                         float s, float* out) {
  float t[11];
  for (int q = 0; q < 11; ++q) t[q] = 0.f;
  for (int i = 0; i < la; ++i)
    for (int j = 0; j < lb; ++j)
      if (i + j < 11) t[i + j] = __fmaf_rn(a[i], b[j], t[i + j]);
  for (int q = 0; q < 11; ++q) out[q] = __fmaf_rn(s, t[q], out[q]);
}

__device__ float polyval(const float* c, int len, float z) {
  float out = 0.f;
  for (int k = len - 1; k >= 0; --k)
    out = __fadd_rn(__fmul_rn(out, z), c[k]);
  return out;
}

// load the sample's rows as the columns of A^T; sets sh.ok (every row in
// range and valid). Returns false when a row index is out of range.
__device__ bool load_sample(Sample& sh, const float* xl, const float* xr,
                            const uint8_t* valid, int n, const int64_t* idx,
                            int k, int lane) {
  if (lane == 0) sh.ok = 1;
  __syncwarp();
  if (lane < k) {
    const int64_t r = idx[lane];
    if (r < 0 || r >= n) {
      sh.ok = 0;
      for (int e = 0; e < 9; ++e) sh.a[lane][e] = 0.f;
    } else {
      if (!valid[r]) sh.ok = 0;   // a benign race: every writer writes 0
      const float hl[3] = {xl[2 * r], xl[2 * r + 1], 1.f};
      const float hr[3] = {xr[2 * r], xr[2 * r + 1], 1.f};
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          sh.a[lane][3 * i + j] = __fmul_rn(hl[i], hr[j]);
    }
  }
  __syncwarp();
  bool in_range = true;
  for (int c = 0; c < k; ++c) {
    const int64_t r = idx[c];
    in_range = in_range && r >= 0 && r < n;
  }
  return in_range;
}

__device__ void write_nan(float* cand, uint8_t* cand_ok, int slots,
                          int lane) {
  const float nan = __int_as_float(0x7fc00000);
  for (int q = lane; q < 9 * slots; q += 32) cand[q] = nan;
  if (lane < slots) cand_ok[lane] = 0;
}

// ------------------------------------------------------------ 5-point --

__device__ void five_point(Sample& sh, const float* theta, int lane,
                           float* cand, uint8_t* cand_ok) {
  householder_qr(sh, 5, lane);
  if (lane < 4) {
    float y[9];
    q_column(sh, 5, 5 + lane, y);
    for (int e = 0; e < 9; ++e) sh.null_[lane][e] = y[e];
  }
  __syncwarp();
  if (lane < 9)
    for (int b = 0; b < 4; ++b) sh.ep[lane][b] = sh.null_[b][lane];
  __syncwarp();
  // C[i][k] = sum_m p11(Ep[i][m], Ep[k][m])
  if (lane < 9) {
    const int i = lane / 3, k = lane % 3;
    float acc[10], t[10];
    for (int q = 0; q < 10; ++q) acc[q] = 0.f;
    for (int m = 0; m < 3; ++m) {
      p11(sh.ep[3 * i + m], sh.ep[3 * k + m], t);
      for (int q = 0; q < 10; ++q) acc[q] = __fadd_rn(acc[q], t[q]);
    }
    for (int q = 0; q < 10; ++q) sh.c[lane][q] = acc[q];
  }
  __syncwarp();
  // the 10 constraint rows: det E, then 2 E E^T E - tr(E E^T) E
  if (lane < 10) {
    float row[20];
    for (int q = 0; q < 20; ++q) row[q] = 0.f;
    if (lane == 0) {
      float ma[10], mb[10], mi[10];
      const int cols[3][2] = {{1, 2}, {0, 2}, {0, 1}};
      const float sgn[3] = {1.f, -1.f, 1.f};
      for (int c = 0; c < 3; ++c) {
        const int j0 = cols[c][0], j1 = cols[c][1];
        p11(sh.ep[3 + j0], sh.ep[6 + j1], ma);
        p11(sh.ep[3 + j1], sh.ep[6 + j0], mb);
        for (int q = 0; q < 10; ++q) mi[q] = __fsub_rn(ma[q], mb[q]);
        p21_acc(mi, sh.ep[c], sgn[c], row);
      }
    } else {
      const int i = (lane - 1) / 3, j = (lane - 1) % 3;
      for (int k = 0; k < 3; ++k) p21_acc(sh.c[3 * i + k], sh.ep[3 * k + j],
                                          2.f, row);
      float tr[10];
      for (int q = 0; q < 10; ++q)
        tr[q] = __fadd_rn(__fadd_rn(sh.c[0][q], sh.c[4][q]), sh.c[8][q]);
      p21_acc(tr, sh.ep[3 * i + j], -1.f, row);
    }
    for (int q = 0; q < 20; ++q) sh.m[lane][q] = row[q];
  }
  __syncwarp();
  // M[:, :10] P = M[:, 10:] by LU with partial pivoting; lane = column
  for (int k = 0; k < 10; ++k) {
    int p = k;
    float best = fabsf(sh.m[k][k]);
    for (int r = k + 1; r < 10; ++r) {
      const float v = fabsf(sh.m[r][k]);
      if (v > best) { best = v; p = r; }
    }
    if (p != k && lane < 20) {
      const float t = sh.m[k][lane];
      sh.m[k][lane] = sh.m[p][lane];
      sh.m[p][lane] = t;
    }
    __syncwarp();
    if (lane == k) {
      const float rcp = __frcp_rn(sh.m[k][k]);
      for (int r = k + 1; r < 10; ++r) sh.m[r][k] = __fmul_rn(sh.m[r][k], rcp);
    }
    __syncwarp();
    if (lane > k && lane < 20) {
      const float u = -sh.m[k][lane];
      for (int r = k + 1; r < 10; ++r)
        sh.m[r][lane] = __fmaf_rn(sh.m[r][k], u, sh.m[r][lane]);
    }
    __syncwarp();
  }
  if (lane >= 10 && lane < 20) {   // back substitution, a column a lane
    for (int k = 9; k >= 0; --k) {
      const float bk = __fdiv_rn(sh.m[k][lane], sh.m[k][k]);
      sh.m[k][lane] = bk;
      for (int r = 0; r < k; ++r)
        sh.m[r][lane] = __fmaf_rn(-bk, sh.m[r][k], sh.m[r][lane]);
    }
  }
  __syncwarp();
  // B(z) from rows 4..9 of P (columns 10..19 of m), then det B
  if (lane == 0) {
    const float* P[6];
    for (int i = 0; i < 6; ++i) P[i] = &sh.m[4 + i][10];
    for (int r = 0; r < 3; ++r) {
      const float* pa = P[2 * r];
      const float* pb = P[2 * r + 1];
      // p = [P2, P1, P0, 0], q = [P5, P4, P3, 0], r = [P9, P8, P7, P6, 0];
      // B[r][c] = poly_a - z poly_b
      const float ea[3][5] = {{pa[2], pa[1], pa[0], 0.f, 0.f},
                              {pa[5], pa[4], pa[3], 0.f, 0.f},
                              {pa[9], pa[8], pa[7], pa[6], 0.f}};
      const float eb[3][5] = {{pb[2], pb[1], pb[0], 0.f, 0.f},
                              {pb[5], pb[4], pb[3], 0.f, 0.f},
                              {pb[9], pb[8], pb[7], pb[6], 0.f}};
      for (int c = 0; c < 3; ++c) {
        const int len = c == 2 ? 5 : 4;
        sh.bp[r][c][0] = __fsub_rn(ea[c][0], 0.f);
        for (int q = 1; q < len; ++q)
          sh.bp[r][c][q] = __fsub_rn(ea[c][q], eb[c][q - 1]);
        for (int q = len; q < 5; ++q) sh.bp[r][c][q] = 0.f;
      }
    }
    const int lens[3] = {4, 4, 5};
    const int cols[3][2] = {{1, 2}, {0, 2}, {0, 1}};
    const float sgn[3] = {1.f, -1.f, 1.f};
    float detb[11];
    for (int q = 0; q < 11; ++q) detb[q] = 0.f;
    for (int c = 0; c < 3; ++c) {
      const int c0 = cols[c][0], c1 = cols[c][1];
      float d2[11];
      for (int q = 0; q < 11; ++q) d2[q] = 0.f;
      conv_acc(sh.bp[1][c0], lens[c0], sh.bp[2][c1], lens[c1], 1.f, d2);
      conv_acc(sh.bp[1][c1], lens[c1], sh.bp[2][c0], lens[c0], -1.f, d2);
      conv_acc(sh.bp[0][c], lens[c], d2, 11, sgn[c], detb);
    }
    for (int q = 0; q < 11; ++q) sh.detb[q] = detb[q];
  }
  __syncwarp();
  // the sign of det B on the grid, 16 points a lane
  for (int g = lane; g < kGrid; g += 32) {
    const float v = poly_tan_eval(sh.detb, theta[g]);
    sh.sgn[g] = v > 0.f ? 1 : (v < 0.f ? -1 : 0);
  }
  __syncwarp();
  // the first kMaxRoots sign changes in grid order
  int found = 0;
  for (int base = 0; base < kGrid - 1 && found < kMaxRoots; base += 32) {
    const int g = base + lane;
    const bool change = g < kGrid - 1 && sh.sgn[g] * sh.sgn[g + 1] < 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, change);
    const int rank = found + __popc(ballot & ((1u << lane) - 1u));
    if (change && rank < kMaxRoots) sh.roots[rank] = g;
    found += __popc(ballot);
  }
  if (lane == 0) sh.n_roots = found < kMaxRoots ? found : kMaxRoots;
  __syncwarp();
  // bisection and back substitution, a root a lane
  if (lane < kMaxRoots) {
    float e_out[9];
    bool ok = false;
    if (lane < sh.n_roots) {
      const int g = sh.roots[lane];
      float lo = theta[g], hi = theta[g + 1];
      float flo = poly_tan_eval(sh.detb, lo);
      for (int it = 0; it < kBisect; ++it) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
        const float fmid = poly_tan_eval(sh.detb, mid);
        if (__fmul_rn(flo, fmid) > 0.f) {
          lo = mid;
          flo = fmid;
        } else {
          hi = mid;
        }
      }
      const float z = tanf(__fmul_rn(0.5f, __fadd_rn(lo, hi)));
      ok = fabsf(z) < 1e6f;
      const int lens[3] = {4, 4, 5};
      float b[2][3];
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 3; ++j) b[i][j] = polyval(sh.bp[i][j], lens[j], z);
      const float den = __fsub_rn(__fmul_rn(b[0][0], b[1][1]),
                                  __fmul_rn(b[0][1], b[1][0]));
      const float x = __fdiv_rn(
          __fadd_rn(__fmul_rn(-b[0][2], b[1][1]), __fmul_rn(b[0][1], b[1][2])),
          den);
      const float y = __fdiv_rn(
          __fadd_rn(__fmul_rn(-b[0][0], b[1][2]), __fmul_rn(b[0][2], b[1][0])),
          den);
      float n2 = 0.f;
      for (int e = 0; e < 9; ++e) {
        const float v = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(x, sh.null_[0][e]),
                                __fmul_rn(y, sh.null_[1][e])),
                      __fmul_rn(z, sh.null_[2][e])),
            sh.null_[3][e]);
        e_out[e] = v;
        n2 = __fmaf_rn(v, v, n2);
      }
      const float norm = fmaxf(sqrtf(n2), 1e-12f);
      for (int e = 0; e < 9; ++e) e_out[e] = __fdiv_rn(e_out[e], norm);
    }
    const float nan = __int_as_float(0x7fc00000);
    for (int e = 0; e < 9; ++e) cand[9 * lane + e] = ok ? e_out[e] : nan;
    cand_ok[lane] = ok && sh.ok;
  }
}

// ------------------------------------------------------------ 8-point --

// eigenvalues (ascending) and eigenvectors (columns of v) of the
// symmetric 3x3 a, by cyclic Jacobi rotations
__device__ void jacobi3(float a[3][3], float w[3], float v[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) v[i][j] = i == j ? 1.f : 0.f;
  const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  for (int sweep = 0; sweep < 12; ++sweep) {
    const float off = fabsf(a[0][1]) + fabsf(a[0][2]) + fabsf(a[1][2]);
    const float diag = fabsf(a[0][0]) + fabsf(a[1][1]) + fabsf(a[2][2]);
    if (off == 0.f || off <= 1e-12f * diag) break;
    for (int pq = 0; pq < 3; ++pq) {
      const int p = pairs[pq][0], q = pairs[pq][1];
      const float apq = a[p][q];
      if (apq == 0.f) continue;
      const float th = (a[q][q] - a[p][p]) / (2.f * apq);
      float t = 1.f / (fabsf(th) + sqrtf(th * th + 1.f));
      if (th < 0.f) t = -t;
      if (!isfinite(th * th)) t = 0.5f / th;
      const float c = 1.f / sqrtf(t * t + 1.f);
      const float s = t * c;
      // a <- J^T a J with J the rotation in the (p, q) plane
      for (int k = 0; k < 3; ++k) {
        const float akp = a[k][p], akq = a[k][q];
        a[k][p] = c * akp - s * akq;
        a[k][q] = s * akp + c * akq;
      }
      for (int k = 0; k < 3; ++k) {
        const float apk = a[p][k], aqk = a[q][k];
        a[p][k] = c * apk - s * aqk;
        a[q][k] = s * apk + c * aqk;
      }
      a[p][q] = a[q][p] = 0.f;
      for (int k = 0; k < 3; ++k) {
        const float vkp = v[k][p], vkq = v[k][q];
        v[k][p] = c * vkp - s * vkq;
        v[k][q] = s * vkp + c * vkq;
      }
    }
  }
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (a[order[j]][order[j]] < a[order[i]][order[i]]) {
        const int t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
  float vs[3][3];
  for (int i = 0; i < 3; ++i) {
    w[i] = a[order[i]][order[i]];
    for (int k = 0; k < 3; ++k) vs[k][i] = v[k][order[i]];
  }
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) v[k][i] = vs[k][i];
}

__device__ void eight_point(Sample& sh, int lane, float* cand,
                            uint8_t* cand_ok) {
  householder_qr(sh, 8, lane);
  if (lane == 0) {
    float e[9];
    q_column(sh, 8, 8, e);
    float E[3][3], ete[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) E[i][j] = e[3 * i + j];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        float acc = 0.f;
        for (int i = 0; i < 3; ++i) acc = __fmaf_rn(E[i][a], E[i][b], acc);
        ete[a][b] = acc;
      }
    float lam[3], V[3][3];
    jacobi3(ete, lam, V);
    float s[3];
    for (int i = 0; i < 3; ++i) s[i] = sqrtf(fmaxf(lam[i], 1e-20f));
    const float sigma = __fmul_rn(0.5f, __fadd_rn(s[2], s[1]));
    float outer[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        outer[a][b] = __fadd_rn(
            __fdiv_rn(__fmul_rn(V[a][2], V[b][2]), s[2]),
            __fdiv_rn(__fmul_rn(V[a][1], V[b][1]), s[1]));
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        float acc = 0.f;
        for (int k = 0; k < 3; ++k) acc = __fmaf_rn(E[i][k], outer[k][j], acc);
        cand[3 * i + j] = __fmul_rn(sigma, acc);
      }
    cand_ok[0] = sh.ok;
  }
}

__global__ void __launch_bounds__(32)
ransac_hypotheses_kernel(const float* __restrict__ xl, const float* __restrict__ xr,
                  const uint8_t* __restrict__ valid, int n,
                  const int64_t* __restrict__ idx5, int n5,
                  const int64_t* __restrict__ idx8,
                  const float* __restrict__ theta, float* cand,
                  uint8_t* cand_ok) {
  __shared__ Sample sh;
  const int lane = threadIdx.x;
  const int s = blockIdx.x;
  if (s < n5) {
    float* c = cand + 90 * static_cast<size_t>(s);
    uint8_t* ok = cand_ok + 10 * static_cast<size_t>(s);
    if (!load_sample(sh, xl, xr, valid, n, idx5 + 5 * static_cast<size_t>(s),
                     5, lane)) {
      write_nan(c, ok, kMaxRoots, lane);
      return;
    }
    five_point(sh, theta, lane, c, ok);
  } else {
    const int s8 = s - n5;
    float* c = cand + 90 * static_cast<size_t>(n5) + 9 * static_cast<size_t>(s8);
    uint8_t* ok = cand_ok + 10 * static_cast<size_t>(n5) + s8;
    if (!load_sample(sh, xl, xr, valid, n, idx8 + 8 * static_cast<size_t>(s8),
                     8, lane)) {
      write_nan(c, ok, 1, lane);
      return;
    }
    eight_point(sh, lane, c, ok);
  }
}

// ------------------------------------------------------------ scoring --

// the squared Sampson distance of row (hl, hr) under E, in the plain
// version's order of operations
__device__ __forceinline__ float sampson(const float* E, float l0, float l1,
                                         float r0, float r1) {
  float exr[3], etxl[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    exr[i] = __fadd_rn(__fadd_rn(__fmul_rn(E[3 * i], r0),
                                 __fmul_rn(E[3 * i + 1], r1)), E[3 * i + 2]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    etxl[i] = __fadd_rn(__fadd_rn(__fmul_rn(E[i], l0), __fmul_rn(E[3 + i], l1)),
                        E[6 + i]);
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(l0, exr[0]),
                                        __fmul_rn(l1, exr[1])), exr[2]);
  const float num = sq(dot);
  const float den = __fadd_rn(__fadd_rn(__fadd_rn(sq(exr[0]), sq(exr[1])),
                                        sq(etxl[0])), sq(etxl[1]));
  return __fdiv_rn(num, fmaxf(den, 1e-12f));
}

// (err / focal)^2 as the plain version forms it from a focal tensor
// (torch's scalar / tensor is reciprocal(tensor) * scalar), else th
__device__ __forceinline__ float threshold(const float* focal, float err,
                                           float th) {
  if (focal == nullptr) return th;
  return sq(__fmul_rn(__frcp_rn(*focal), err));
}

__device__ __forceinline__ bool finite9(const float* E) {
  bool f = true;
#pragma unroll
  for (int e = 0; e < 9; ++e) f = f && isfinite(E[e]);
  return f;
}

template <int kThreads>
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) t += red[i];
  return t;   // thread 0's
}

__global__ void __launch_bounds__(kScoreThreads)
ransac_score_kernel(const float* __restrict__ xl, const float* __restrict__ xr,
             const uint8_t* __restrict__ valid, int n,
             const float* __restrict__ cand,
             const uint8_t* __restrict__ cand_ok, const float* focal,
             float err, float th_value, float* quality) {
  __shared__ float red[kScoreThreads / 32];
  const int c = blockIdx.x;
  float E[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) E[e] = cand[9 * static_cast<size_t>(c) + e];
  if (!cand_ok[c] || !finite9(E)) {
    if (threadIdx.x == 0) quality[c] = -1.f;
    return;
  }
  const float th = threshold(focal, err, th_value);
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kScoreThreads) {
    const float d2 = sampson(E, xl[2 * i], xl[2 * i + 1], xr[2 * i],
                             xr[2 * i + 1]);
    if (d2 < th && valid[i]) acc += __fsub_rn(1.f, __fdiv_rn(d2, th));
  }
  const float q = block_sum<kScoreThreads>(acc, red);
  if (threadIdx.x == 0) quality[c] = q;
}

// ---------------------------------------------------------- selection --

__device__ __forceinline__ unsigned long long pack_key(float q, int idx) {
  uint32_t u = __float_as_uint(q);
  uint32_t key;
  if (isnan(q)) key = 0xffffffffu;                 // argmax: NaN wins
  else key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(key) << 32) |
         static_cast<unsigned long long>(0xffffffffu - static_cast<uint32_t>(idx));
}

__global__ void __launch_bounds__(kSelectThreads)
ransac_select_kernel(const float* __restrict__ xl, const float* __restrict__ xr,
              const uint8_t* __restrict__ valid, int n,
              const float* __restrict__ cand,
              const float* __restrict__ quality, int n_cand,
              const float* focal, float err, float th_value, float* out_e,
              uint8_t* out_inl, int64_t* out_n) {
  __shared__ unsigned long long redk[kSelectThreads / 32];
  __shared__ float E[9];
  __shared__ int counts[kSelectThreads / 32];
  unsigned long long best = 0ull;
  for (int c = threadIdx.x; c < n_cand; c += kSelectThreads) {
    const unsigned long long k = pack_key(quality[c], c);
    best = k > best ? k : best;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, o);
    best = other > best ? other : best;
  }
  const int w = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) redk[w] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long b = 0ull;
    for (int i = 0; i < kSelectThreads / 32; ++i) b = redk[i] > b ? redk[i] : b;
    const int win = static_cast<int>(0xffffffffu - static_cast<uint32_t>(b));
    float e[9];
    for (int q = 0; q < 9; ++q) e[q] = cand[9 * static_cast<size_t>(win) + q];
    const bool fin = finite9(e);
    for (int q = 0; q < 9; ++q) E[q] = fin ? e[q] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 9) out_e[threadIdx.x] = E[threadIdx.x];
  float e[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) e[q] = E[q];
  const float th = threshold(focal, err, th_value);
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += kSelectThreads) {
    const float d2 = sampson(e, xl[2 * i], xl[2 * i + 1], xr[2 * i],
                             xr[2 * i + 1]);
    const bool inl = d2 < th && valid[i];
    out_inl[i] = inl;
    cnt += inl;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0) counts[w] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t t = 0;
    for (int i = 0; i < kSelectThreads / 32; ++i) t += counts[i];
    out_n[0] = t;
  }
}

}  // namespace

// Launches the three kernels on ``stream``; returns 0, a cudaError_t, or -1
// for arguments the kernels are not sized for. Device pointers: xl, xr
// (n, 2) f32 contiguous, valid (n,) bytes, idx5 (n5, 5) and idx8 (n8, 8)
// int64 contiguous (an index outside [0, n) makes its sample's candidates
// NaN and not ok), theta (512,) f32 (the plain version's grid), focal null
// or one f32 (then th = (err / focal)^2, else th = th_value); scratch
// cand (10 n5 + n8, 9) f32, cand_ok (10 n5 + n8,) bytes, quality
// (10 n5 + n8,) f32 (the candidates and their qualities, kept for
// checks); outputs out_e (3, 3) f32, out_inl (n,) bytes, out_n one int64.
extern "C" int essential_ransac_launch(const void* xl, const void* xr,
                                       const void* valid, int n,
                                       const void* idx5, int n5,
                                       const void* idx8, int n8,
                                       const void* theta, const void* focal,
                                       float err, float th_value, void* cand,
                                       void* cand_ok, void* quality,
                                       void* out_e, void* out_inl,
                                       void* out_n, void* stream) {
  if (n < 1 || n5 < 0 || n8 < 0 || n5 + n8 < 1) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(xl);
  const auto* r = static_cast<const float*>(xr);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* f = static_cast<const float*>(focal);
  auto* c = static_cast<float*>(cand);
  auto* q = static_cast<float*>(quality);
  const int n_cand = 10 * n5 + n8;
  ransac_hypotheses_kernel<<<n5 + n8, 32, 0, s>>>(
      l, r, v, n, static_cast<const int64_t*>(idx5), n5,
      static_cast<const int64_t*>(idx8), static_cast<const float*>(theta), c,
      static_cast<uint8_t*>(cand_ok));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ransac_score_kernel<<<n_cand, kScoreThreads, 0, s>>>(
      l, r, v, n, c, static_cast<const uint8_t*>(cand_ok), f, err, th_value,
      q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ransac_select_kernel<<<1, kSelectThreads, 0, s>>>(
      l, r, v, n, c, q, n_cand, f, err, th_value,
      static_cast<float*>(out_e), static_cast<uint8_t*>(out_inl),
      static_cast<int64_t*>(out_n));
  return static_cast<int>(cudaGetLastError());
}
