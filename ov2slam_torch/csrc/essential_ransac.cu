// Essential-matrix RANSAC (Nister 5-point samples plus an 8-point pool,
// Sampson-scored together) in one launch: a CTA a sample, the selection by
// the last CTA to finish.
//
// Replaces the XLA-compiled form of ov2slam_tpu/geometry/essential.py:385
// essential_ransac (five_point :299, _real_roots_deg10 :261, eight_point
// :70, sampson_dist_sq :53), which the JAX package fuses into its jitted
// tracking step. No Pallas kernel stands behind it. The plain PyTorch
// version is geometry/essential.py::essential_ransac_plain; this file
// computes what it computes:
//
//   - 5-point (warp 0 unless said): the null space of the 5x9 system from
//     a Householder QR of its transpose in LAPACK's convention (geqr2: beta
//     = -sign(alpha) * |x|, tau = (beta - alpha) / beta; the complete Q's
//     columns 5..8 as org2r forms them, H(4) first), the 10x20 Nister
//     constraint rows from the same monomial tables as the plain version
//     (_T112, _T213), the 10x10 system solved by LU with partial pivoting
//     (getf2: the first largest pivot, multipliers by the reciprocal,
//     rank-1 updates; getrs on the 10 right-hand sides), the degree-10
//     det B(z) (its three cofactor products on three lanes, summed in
//     order on one), these three in f64 from the f32 null space, then B(z)
//     and det B rounded to f32; its real roots from the first 10 sign
//     changes in grid
//     order of cos^10(t) p(tan t) on the plain version's 512-point grid
//     (passed in, torch.linspace's own values; every thread of the CTA
//     evaluates two points, every warp ranks the changes of its part), 60
//     bisection steps in t (a warp a root, see below) and the |z| < 1e6
//     gate, then x and y from B(z), E normalised;
//     NaN in slots without a root.
//   - 8-point: the null vector of the 8x9 system (the same QR, column 8),
//     then the rank-2 projection through the eigenvectors of E^T E
//     (cyclic Jacobi on the 3x3 in registers, eigenvalues sorted
//     ascending; the plain version's 3x3 eigh).
//   - the scores: a group of 128 threads a candidate; the Sampson distance
//     of every row, inlier = d2 < th & valid, quality = sum over inliers of
//     1 - d2/th; -1 for a candidate that is not ok (a sample row invalid,
//     no root) or not finite.
//   - the selection, by the CTA that takes the last ticket of the launch:
//     argmax of quality with torch.argmax's rule (the first index of the
//     largest value; NaN largest), from a u64 packed as (order-preserving
//     quality bits, ~index); then the winner's E (zero where not finite),
//     its inlier mask and count. It sets the ticket back to 0. The wrapper
//     keeps one ticket per (device, stream): launches on one stream run in
//     turn, and two streams never share one.
//
// The root search, exactly. Sequential bisection steps (mid = (lo + hi) /
// 2 rounded as below; keep [mid, hi] where flo * f(mid) > 0, else [lo,
// mid]) are taken five at a time: lane j < 31 of the root's warp takes node
// j of the binary tree of the next five steps, replays the midpoints on
// its path with the same rounding and evaluates f at its node; the warp
// then walks the five levels with the sequential test, reading each
// node's midpoint and value by shuffle. Every value is one the sequential
// steps compute, so the bracket is theirs bit for bit. A step that leaves
// (lo, hi, flo) unchanged, as bits (a NaN flo included), repeats itself
// for good: the walk stops after the round that holds one, with the state
// of all 60 steps. A bracket one grid cell wide stops after 17-25 steps
// (4-5 rounds); 60 remains the cap, near t = 0 where floats are dense.
//
// Rounding. Explicit _rn intrinsics in the 5-point path, no contraction.
// The constraint rows, their solve and det B run in f64: in f32 that
// stage loses the roots' digits on some samples (a 10x10 elimination of
// products of the null space; on a real loop-closure sample a root moved
// by 1e-3 relative, where the same stage in f64 from the same f32 null
// space keeps 1e-5). Sums run in a fixed order (each
// thread's rows in index order, then a xor butterfly of shuffles and the
// group's warps in order; no atomics), so two launches agree bit for bit.
// Against the plain version the small linear algebra rounds in another
// order (its QR, LU and eigh are LAPACK's or cuSOLVER's), so candidates
// agree to round-off; the Sampson distance uses the same expression for
// the scores and the selection, so the winner's mask is the one its
// quality was summed over. Never build with --use_fast_math.
//
// Bound on an H100 SXM. At the front end's call (N = 512 rows, 100
// 5-point and 25 8-point samples, 1025 candidates) the scoring is ~36
// FLOP a row and scored candidate, a 5-point sample ~10 kFLOP before its
// roots and 512 grid evaluations of ~55 FLOP, each root one evaluation a
// bisection step up to its bracket's fixed point (~18 at slice B's data)
// and the back substitution (roofline.py::essential_ransac_bound counts
// them at this data): ~13 MFLOP, 0.0002 ms at 67 TFLOP/s; the bytes
// (rows, samples, grid, E and the mask) ~17 KB. Neither binds: a sample's
// QR, LU, det B and root search are a dependent chain, and a call takes
// about what one sample's CTA does.
//
// Design. A CTA of 8 warps a sample. Warp 0 runs the linear algebra with
// a column a lane in registers (the QR's and the LU's; pivots, reflectors
// and multipliers go by shuffle) and the small polynomial products from
// tables the compiler sees, so that they index registers; the grid is
// spread over all 256 threads and the sign changes over the warps; each
// root gets a warp (roots 8 and 9 a second turn); the candidates are
// scored by two groups of four warps; the scores and the ticket need no
// second launch. wgmma does not apply: the matrices are 10x20 at most and
// the work is a chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGrid = 512;        // the root search's grid (essential.py)
constexpr int kMaxRoots = 10;
constexpr int kBisect = 60;
constexpr int kLevels = 5;        // bisection steps a speculative round
constexpr int kThreads = 256;     // a CTA a sample
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 128;       // threads scoring one candidate
constexpr int kGroups = kThreads / kGroup;

// monomial products: deg1 x deg1 -> deg2 and deg2 x deg1 -> deg3 indices
// (essential.py's _T112, _T213 as index tables), known to the compiler so
// that the unrolled products index registers, not local memory
__device__ __forceinline__ constexpr int t112(int i, int j) {
  constexpr int8_t k[4][4] = {
      {0, 1, 3, 6}, {1, 2, 4, 7}, {3, 4, 5, 8}, {6, 7, 8, 9}};
  return k[i][j];
}
__device__ __forceinline__ constexpr int t213(int i, int j) {
  constexpr int8_t k[10][4] = {
      {0, 2, 4, 5},   {2, 3, 8, 9},    {3, 1, 6, 7},    {4, 8, 10, 11},
      {8, 6, 13, 14}, {10, 13, 16, 17}, {5, 9, 11, 12}, {9, 7, 14, 15},
      {11, 14, 17, 18}, {12, 15, 18, 19}};
  return k[i][j];
}

struct Sample {
  float a[8][9];        // A^T by columns (a sample row each), then the QR
  float tau[8];
  float null_[4][9];    // null-space columns of Q (X, Y, Z, W / e)
  float ep[9][4];       // E's entries as deg-1 polynomials in (x, y, z, 1)
  double c[9][10];      // C[i][k] = sum_m Ep[i][m] Ep[k][m], deg 2
  double m[10][20];     // constraint rows; after the solve, P in 10..19
  double bp[3][3][5];   // B(z): rows (4,5), (6,7), (8,9) of P
  double d2[3][11];     // det B's cofactor products
  float bpf[3][3][5];   // B(z) and det B rounded to f32 for the roots
  float detb[11];
  float gv[kGrid];      // det B on the grid (flo at a bracket's lower end)
  int8_t sgn[kGrid];
  float cand[kMaxRoots][9];   // the sample's candidates, for the scores
  float red[kMaxRoots][kGroup / 32];
  int roots[kMaxRoots];
  int changes[kWarps];  // sign changes a warp's part of the grid holds
  uint8_t cand_ok[kMaxRoots];
  int n_roots;
  int ok;
  int in_range;
  int last;
};

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// the fused multiply-add of each precision, rounded once
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

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

// Householder QR of the 9 x K matrix sh.a (K = 5 or 8 columns) in
// LAPACK's geqr2 convention: lane j holds column j in registers, lane i
// forms reflector i and sends it by shuffle, the lanes right of it apply
// it to their columns; the reflectors and taus end in sh.a and sh.tau
template <int K>
__device__ void householder_qr(Sample& sh, int lane) {
  float col[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) col[r] = lane < K ? sh.a[lane][r] : 0.f;
  float my_tau = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (lane == i) {
      const float alpha = col[i];
      float xn2 = 0.f;
#pragma unroll
      for (int r = i + 1; r < 9; ++r) xn2 = __fmaf_rn(col[r], col[r], xn2);
      if (xn2 != 0.f) {
        const float norm = sqrtf(__fmaf_rn(alpha, alpha, xn2));
        const float beta = alpha >= 0.f ? -norm : norm;
        my_tau = __fdiv_rn(__fsub_rn(beta, alpha), beta);
        const float scal = __frcp_rn(__fsub_rn(alpha, beta));
#pragma unroll
        for (int r = i + 1; r < 9; ++r) col[r] = __fmul_rn(col[r], scal);
        col[i] = beta;
      }
    }
    // apply H(i) = I - tau v v^T (v = [1, a[i][i+1..8]]) to columns > i
    const float tau = __shfl_sync(0xffffffffu, my_tau, i);
    float v[9];
#pragma unroll
    for (int r = i + 1; r < 9; ++r) v[r] = __shfl_sync(0xffffffffu, col[r], i);
    if (lane > i && lane < K && tau != 0.f) {
      float w = col[i];
#pragma unroll
      for (int r = i + 1; r < 9; ++r) w = __fmaf_rn(col[r], v[r], w);
      const float t = -__fmul_rn(tau, w);
      col[i] = __fadd_rn(col[i], t);
#pragma unroll
      for (int r = i + 1; r < 9; ++r) col[r] = __fmaf_rn(v[r], t, col[r]);
    }
  }
  if (lane < K) {
#pragma unroll
    for (int r = 0; r < 9; ++r) sh.a[lane][r] = col[r];
    sh.tau[lane] = my_tau;
  }
  __syncwarp();
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

// deg1 x deg1 -> deg2 of f32 coefficients, in f64
__device__ __forceinline__ void p11(const float* a, const float* b,
                                    double* out) {
#pragma unroll
  for (int t = 0; t < 10; ++t) out[t] = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[t112(i, j)] = __fma_rn(static_cast<double>(a[i]),
                                 static_cast<double>(b[j]), out[t112(i, j)]);
}

// out += s * p21(a, b) (deg2 x deg1 -> deg3), in f64
__device__ __forceinline__ void p21_acc(const double* a, const float* b,
                                        double s, double* out) {
  double t[20];
#pragma unroll
  for (int q = 0; q < 20; ++q) t[q] = 0.0;
#pragma unroll
  for (int i = 0; i < 10; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      t[t213(i, j)] = __fma_rn(a[i], static_cast<double>(b[j]),
                               t[t213(i, j)]);
#pragma unroll
  for (int q = 0; q < 20; ++q) out[q] = __fma_rn(s, t[q], out[q]);
}

// polynomial product truncated to 11 coefficients: out += s * a * b, for
// a of la <= MA and b of lb <= MB coefficients (the products outside them
// predicated off, so the lanes of a warp share one path)
template <int MA, int MB, typename T>
__device__ __forceinline__ void conv_acc(const T* a, int la, const T* b,
                                         int lb, T s, T* out) {
  T t[11];
#pragma unroll
  for (int q = 0; q < 11; ++q) t[q] = 0;
#pragma unroll
  for (int i = 0; i < MA; ++i)
#pragma unroll
    for (int j = 0; j < MB; ++j)
      if (i < la && j < lb && i + j < 11)
        t[i + j] = fma_rn(a[i], b[j], t[i + j]);
#pragma unroll
  for (int q = 0; q < 11; ++q) out[q] = fma_rn(s, t[q], out[q]);
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

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// The bisection of one bracket, by the whole warp: (lo, hi, flo) after
// kBisect sequential steps, five steps a round (see the header). Returns
// the sequential steps up to the first that leaves the bracket as it was,
// that one included, or kBisect (the evaluations these data need).
__device__ int bisect_warp(const float* c, float& lo, float& hi, float& flo,
                           int lane) {
  // node j of the round's tree in heap order: children 2j + 1 (the step
  // keeps [lo, mid]) and 2j + 2 (it keeps [mid, hi]); the bits of j + 1
  // after its leading one are the path from the root; lane 31 repeats
  // node 0
  const int j = lane < 31 ? lane : 0;
  const int depth = 31 - __clz(j + 1);
  int steps = 0;
  bool still = false;
  for (int round = 0; round < kBisect / kLevels && !still; ++round) {
    float l = lo, h = hi;
    for (int d = depth - 1; d >= 0; --d) {
      const float m = __fmul_rn(0.5f, __fadd_rn(l, h));
      if (((j + 1) >> d) & 1) l = m;
      else h = m;
    }
    const float mine = __fmul_rn(0.5f, __fadd_rn(l, h));
    const float fmine = poly_tan_eval(c, mine);
    int node = 0;
#pragma unroll
    for (int level = 0; level < kLevels; ++level) {
      const float mid = __shfl_sync(0xffffffffu, mine, node);
      const float fmid = __shfl_sync(0xffffffffu, fmine, node);
      const bool take_lo = __fmul_rn(flo, fmid) > 0.f;
      const float nlo = take_lo ? mid : lo;
      const float nflo = take_lo ? fmid : flo;
      const float nhi = take_lo ? hi : mid;
      if (!still) {
        ++steps;
        still = same_bits(nlo, lo) && same_bits(nhi, hi) &&
                same_bits(nflo, flo);
      }
      lo = nlo;
      hi = nhi;
      flo = nflo;
      node = 2 * node + (take_lo ? 2 : 1);
    }
  }
  return steps;
}

// The candidate of the root in [lo, hi] (x and y from B(z), E normalised);
// returns whether |z| < 1e6
__device__ bool root_candidate(const Sample& sh, float lo, float hi,
                               float e_out[9]) {
  const float z = tanf(__fmul_rn(0.5f, __fadd_rn(lo, hi)));
  const bool ok = fabsf(z) < 1e6f;
  const int lens[3] = {4, 4, 5};
  float b[2][3];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 3; ++j) b[i][j] = polyval(sh.bpf[i][j], lens[j], z);
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
  return ok;
}

// the sample's 10 candidates into cand / cand_ok (global) and sh.cand /
// sh.cand_ok, the steps of each root into steps (or nothing); called by
// the whole CTA, returns after a barrier
__device__ void five_point(Sample& sh, const float* theta, int warp,
                           int lane, float* cand, uint8_t* cand_ok,
                           uint8_t* steps) {
  if (warp == 0) {
    householder_qr<5>(sh, lane);
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
      double acc[10], t[10];
      for (int q = 0; q < 10; ++q) acc[q] = 0.0;
      for (int m = 0; m < 3; ++m) {
        p11(sh.ep[3 * i + m], sh.ep[3 * k + m], t);
        for (int q = 0; q < 10; ++q) acc[q] = __dadd_rn(acc[q], t[q]);
      }
      for (int q = 0; q < 10; ++q) sh.c[lane][q] = acc[q];
    }
    __syncwarp();
    // the 10 constraint rows: det E, then 2 E E^T E - tr(E E^T) E
    if (lane < 10) {
      double row[20];
      for (int q = 0; q < 20; ++q) row[q] = 0.0;
      if (lane == 0) {
        double ma[10], mb[10], mi[10];
        const int cols[3][2] = {{1, 2}, {0, 2}, {0, 1}};
        const double sgn[3] = {1.0, -1.0, 1.0};
        for (int c = 0; c < 3; ++c) {
          const int j0 = cols[c][0], j1 = cols[c][1];
          p11(sh.ep[3 + j0], sh.ep[6 + j1], ma);
          p11(sh.ep[3 + j1], sh.ep[6 + j0], mb);
          for (int q = 0; q < 10; ++q) mi[q] = __dsub_rn(ma[q], mb[q]);
          p21_acc(mi, sh.ep[c], sgn[c], row);
        }
      } else {
        const int i = (lane - 1) / 3, j = (lane - 1) % 3;
        for (int k = 0; k < 3; ++k) p21_acc(sh.c[3 * i + k], sh.ep[3 * k + j],
                                            2.0, row);
        double tr[10];
        for (int q = 0; q < 10; ++q)
          tr[q] = __dadd_rn(__dadd_rn(sh.c[0][q], sh.c[4][q]), sh.c[8][q]);
        p21_acc(tr, sh.ep[3 * i + j], -1.0, row);
      }
      for (int q = 0; q < 20; ++q) sh.m[lane][q] = row[q];
    }
    __syncwarp();
    // M[:, :10] P = M[:, 10:] by LU with partial pivoting; lane = column,
    // held in registers: the pivot found on its column's lane, the
    // multipliers sent by shuffle
    double col[10];
#pragma unroll
    for (int r = 0; r < 10; ++r) col[r] = lane < 20 ? sh.m[r][lane] : 0.0;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      int p = k;
      if (lane == k) {
        double best = fabs(col[k]);
#pragma unroll
        for (int r = k + 1; r < 10; ++r) {
          const double v = fabs(col[r]);
          if (v > best) { best = v; p = r; }
        }
      }
      p = __shfl_sync(0xffffffffu, p, k);
#pragma unroll
      for (int r = k + 1; r < 10; ++r)
        if (r == p) {
          const double t = col[k];
          col[k] = col[r];
          col[r] = t;
        }
      if (lane == k) {
        const double rcp = __drcp_rn(col[k]);
#pragma unroll
        for (int r = k + 1; r < 10; ++r) col[r] = __dmul_rn(col[r], rcp);
      }
      const double u = -col[k];
#pragma unroll
      for (int r = k + 1; r < 10; ++r) {
        const double l = __shfl_sync(0xffffffffu, col[r], k);
        if (lane > k && lane < 20) col[r] = __fma_rn(l, u, col[r]);
      }
    }
    // back substitution, a right-hand side a lane (lanes 10..19)
#pragma unroll
    for (int k = 9; k >= 0; --k) {
      const double diag = __shfl_sync(0xffffffffu, col[k], k);
      const double bk = __ddiv_rn(col[k], diag);
      if (lane >= 10 && lane < 20) col[k] = bk;
#pragma unroll
      for (int r = 0; r < k; ++r) {
        const double ur = __shfl_sync(0xffffffffu, col[r], k);
        if (lane >= 10 && lane < 20) col[r] = __fma_rn(-bk, ur, col[r]);
      }
    }
    if (lane >= 10 && lane < 20)
#pragma unroll
      for (int r = 0; r < 10; ++r) sh.m[r][lane] = col[r];
    __syncwarp();
    // B(z) from rows 4..9 of P (columns 10..19 of m), a row of B a lane
    if (lane < 3) {
      const int r = lane;
      const double* pa = &sh.m[4 + 2 * r][10];
      const double* pb = &sh.m[5 + 2 * r][10];
      // p = [P2, P1, P0, 0], q = [P5, P4, P3, 0], r = [P9, P8, P7, P6, 0];
      // B[r][c] = poly_a - z poly_b
      const double ea[3][5] = {{pa[2], pa[1], pa[0], 0.0, 0.0},
                               {pa[5], pa[4], pa[3], 0.0, 0.0},
                               {pa[9], pa[8], pa[7], pa[6], 0.0}};
      const double eb[3][5] = {{pb[2], pb[1], pb[0], 0.0, 0.0},
                               {pb[5], pb[4], pb[3], 0.0, 0.0},
                               {pb[9], pb[8], pb[7], pb[6], 0.0}};
      for (int c = 0; c < 3; ++c) {
        const int len = c == 2 ? 5 : 4;
        sh.bp[r][c][0] = ea[c][0];
        for (int q = 1; q < len; ++q)
          sh.bp[r][c][q] = __dsub_rn(ea[c][q], eb[c][q - 1]);
        for (int q = len; q < 5; ++q) sh.bp[r][c][q] = 0.0;
        for (int q = 0; q < 5; ++q)
          sh.bpf[r][c][q] = __double2float_rn(sh.bp[r][c][q]);
      }
    }
    __syncwarp();
    // det B: the cofactor products of row 0 a lane, then their sum in
    // order c = 0, 1, 2 on lane 0 (B's columns hold 4, 4 and 5
    // coefficients)
    const int cols[3][2] = {{1, 2}, {0, 2}, {0, 1}};
    if (lane < 3) {
      const int c = lane, c0 = cols[c][0], c1 = cols[c][1];
      const int l0 = c0 == 2 ? 5 : 4, l1 = c1 == 2 ? 5 : 4;
      double d2[11];
#pragma unroll
      for (int q = 0; q < 11; ++q) d2[q] = 0.0;
      conv_acc<5, 5>(sh.bp[1][c0], l0, sh.bp[2][c1], l1, 1.0, d2);
      conv_acc<5, 5>(sh.bp[1][c1], l1, sh.bp[2][c0], l0, -1.0, d2);
#pragma unroll
      for (int q = 0; q < 11; ++q) sh.d2[c][q] = d2[q];
    }
    __syncwarp();
    if (lane == 0) {
      const double sgn[3] = {1.0, -1.0, 1.0};
      double detb[11];
#pragma unroll
      for (int q = 0; q < 11; ++q) detb[q] = 0.0;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        conv_acc<5, 11>(sh.bp[0][c], c == 2 ? 5 : 4, sh.d2[c], 11, sgn[c],
                        detb);
#pragma unroll
      for (int q = 0; q < 11; ++q) sh.detb[q] = __double2float_rn(detb[q]);
    }
  }
  __syncthreads();
  // det B on the grid, two points a thread
  for (int g = threadIdx.x; g < kGrid; g += kThreads) {
    const float v = poly_tan_eval(sh.detb, theta[g]);
    sh.gv[g] = v;
    sh.sgn[g] = v > 0.f ? 1 : (v < 0.f ? -1 : 0);
  }
  __syncthreads();
  // the first kMaxRoots sign changes in grid order: warp w takes the
  // changes after grid points [kSpan w, kSpan (w + 1)) and ranks them after
  // those of the warps before it
  constexpr int kSpan = kGrid / kWarps;
  unsigned ballot[kSpan / 32];
  int found = 0;
#pragma unroll
  for (int h = 0; h < kSpan / 32; ++h) {
    const int g = kSpan * warp + 32 * h + lane;
    const bool change = g < kGrid - 1 && sh.sgn[g] * sh.sgn[g + 1] < 0;
    ballot[h] = __ballot_sync(0xffffffffu, change);
    found += __popc(ballot[h]);
  }
  if (lane == 0) sh.changes[warp] = found;
  __syncthreads();
  found = 0;
  for (int w = 0; w < warp; ++w) found += sh.changes[w];
#pragma unroll
  for (int h = 0; h < kSpan / 32; ++h) {
    const int g = kSpan * warp + 32 * h + lane;
    const int rank = found + __popc(ballot[h] & ((1u << lane) - 1u));
    if (((ballot[h] >> lane) & 1u) && rank < kMaxRoots) sh.roots[rank] = g;
    found += __popc(ballot[h]);
  }
  if (threadIdx.x == kThreads - 1)   // the last warp's count is the total
    sh.n_roots = found < kMaxRoots ? found : kMaxRoots;
  __syncthreads();
  // bisection and back substitution, a root a warp
  for (int r = warp; r < kMaxRoots; r += kWarps) {
    float e_out[9];
    bool ok = false;
    int steps_r = 0;
    if (r < sh.n_roots) {
      const int g = sh.roots[r];
      float lo = theta[g], hi = theta[g + 1];
      float flo = sh.gv[g];
      steps_r = bisect_warp(sh.detb, lo, hi, flo, lane);
      if (lane == 0) ok = root_candidate(sh, lo, hi, e_out);
    }
    if (lane == 0) {
      const float nan = __int_as_float(0x7fc00000);
      for (int e = 0; e < 9; ++e) {
        const float v = ok ? e_out[e] : nan;
        cand[9 * r + e] = v;
        sh.cand[r][e] = v;
      }
      const uint8_t cok = ok && sh.ok;
      cand_ok[r] = cok;
      sh.cand_ok[r] = cok;
      if (steps != nullptr) steps[r] = static_cast<uint8_t>(steps_r);
    }
  }
  __syncthreads();
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
  householder_qr<8>(sh, lane);
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
        const float v = __fmul_rn(sigma, acc);
        cand[3 * i + j] = v;
        sh.cand[0][3 * i + j] = v;
      }
    cand_ok[0] = sh.ok;
    sh.cand_ok[0] = sh.ok;
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

// the qualities of the sample's ``slots`` candidates (sh.cand) into
// quality: a group of 128 threads a candidate (group g takes candidates
// g, g + kGroups, ..., all in one pass over the rows), thread t of the
// group summing rows t, t + 128, ... in order, then a xor butterfly in
// each warp and the group's four warps in order (the three-kernel form's
// scoring, a CTA of 128 threads a candidate); called by the whole CTA,
// returns after a barrier
__device__ void score(Sample& sh, int slots, const float* xl,
                      const float* xr, const uint8_t* valid, int n,
                      float th, float* quality) {
  constexpr int kEach = (kMaxRoots + kGroups - 1) / kGroups;
  const int group = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  bool live[kEach];    // the same for the group
  float acc[kEach];
#pragma unroll
  for (int j = 0; j < kEach; ++j) {
    const int c = group + kGroups * j;
    live[j] = c < slots && sh.cand_ok[c] && finite9(sh.cand[c]);
    acc[j] = 0.f;
  }
  for (int i = t; i < n; i += kGroup) {
    const float l0 = xl[2 * i], l1 = xl[2 * i + 1];
    const float r0 = xr[2 * i], r1 = xr[2 * i + 1];
    const bool v = valid[i];
#pragma unroll
    for (int j = 0; j < kEach; ++j)
      if (live[j]) {
        const float d2 = sampson(sh.cand[group + kGroups * j], l0, l1, r0,
                                 r1);
        if (d2 < th && v) acc[j] += __fsub_rn(1.f, __fdiv_rn(d2, th));
      }
  }
#pragma unroll
  for (int j = 0; j < kEach; ++j)
    if (live[j]) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
      if ((t & 31) == 0) sh.red[group + kGroups * j][t / 32] = acc[j];
    }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < slots) {
    float q = -1.f;
    if (sh.cand_ok[c] && finite9(sh.cand[c])) {
      q = 0.f;
      for (int w = 0; w < kGroup / 32; ++w) q += sh.red[c][w];
    }
    quality[c] = q;
  }
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

// the winner of all n_cand qualities, its E, inlier mask and count, by the
// whole CTA (the last one of the launch: the others' candidates and
// qualities are read past L1)
__device__ void select_winner(const float* xl, const float* xr,
                              const uint8_t* valid, int n, const float* cand,
                              const float* quality, int n_cand, float th,
                              float* out_e, uint8_t* out_inl,
                              int64_t* out_n) {
  __shared__ unsigned long long redk[kWarps];
  __shared__ float E[9];
  __shared__ int counts[kWarps];
  unsigned long long best = 0ull;
  for (int c = threadIdx.x; c < n_cand; c += kThreads) {
    const unsigned long long k = pack_key(__ldcg(quality + c), c);
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
    for (int i = 0; i < kWarps; ++i) b = redk[i] > b ? redk[i] : b;
    const int win = static_cast<int>(0xffffffffu - static_cast<uint32_t>(b));
    float e[9];
    for (int q = 0; q < 9; ++q)
      e[q] = __ldcg(cand + 9 * static_cast<size_t>(win) + q);
    const bool fin = finite9(e);
    for (int q = 0; q < 9; ++q) E[q] = fin ? e[q] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 9) out_e[threadIdx.x] = E[threadIdx.x];
  float e[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) e[q] = E[q];
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
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
    for (int i = 0; i < kWarps; ++i) t += counts[i];
    out_n[0] = t;
  }
}

// ------------------------------------------------------------- kernel --

struct Args {
  const float* xl;
  const float* xr;
  const uint8_t* valid;
  int n;
  const int64_t* idx5;
  int n5;
  const int64_t* idx8;
  const float* theta;
  const float* focal;
  float err, th_value;
  float* cand;
  uint8_t* cand_ok;
  float* quality;
  uint8_t* steps;
  int* ticket;
  float* out_e;
  uint8_t* out_inl;
  int64_t* out_n;
};

__global__ void __launch_bounds__(kThreads)
essential_ransac_kernel(const Args a) {
  __shared__ Sample sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x;
  const bool five = s < a.n5;
  const int k = five ? 5 : 8, slots = five ? kMaxRoots : 1;
  const size_t first = five ? 10 * static_cast<size_t>(s)
                            : 10 * static_cast<size_t>(a.n5) + (s - a.n5);
  float* cand = a.cand + 9 * first;
  uint8_t* cand_ok = a.cand_ok + first;
  float* quality = a.quality + first;
  uint8_t* steps = five && a.steps != nullptr ? a.steps + first : nullptr;
  if (warp == 0) {
    const int64_t* idx = five ? a.idx5 + 5 * static_cast<size_t>(s)
                              : a.idx8 + 8 * static_cast<size_t>(s - a.n5);
    const bool in_range = load_sample(sh, a.xl, a.xr, a.valid, a.n, idx, k,
                                      lane);
    if (lane == 0) sh.in_range = in_range;
  }
  __syncthreads();
  const float th = threshold(a.focal, a.err, a.th_value);
  if (!sh.in_range) {
    if (warp == 0) write_nan(cand, cand_ok, slots, lane);
    const int c = threadIdx.x;
    if (c < slots) {
      quality[c] = -1.f;
      if (steps != nullptr) steps[c] = 0;
    }
  } else {
    if (five) {
      five_point(sh, a.theta, warp, lane, cand, cand_ok, steps);
    } else {
      if (warp == 0) eight_point(sh, lane, cand, cand_ok);
      __syncthreads();
    }
    score(sh, slots, a.xl, a.xr, a.valid, a.n, th, quality);
  }
  // the last CTA to finish selects: every thread's writes are made
  // visible before the ticket is taken, and read past L1 after it
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sh.last = atomicAdd(a.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  const int n_cand = 10 * a.n5 + (static_cast<int>(gridDim.x) - a.n5);
  select_winner(a.xl, a.xr, a.valid, a.n, a.cand, a.quality, n_cand, th,
                a.out_e, a.out_inl, a.out_n);
  if (threadIdx.x == 0) *a.ticket = 0;
}

}  // namespace

// Launches the kernel on ``stream``; returns 0, a cudaError_t, or -1 for
// arguments the kernel is not sized for. Device pointers: xl, xr (n, 2)
// f32 contiguous, valid (n,) bytes, idx5 (n5, 5) and idx8 (n8, 8) int64
// contiguous (an index outside [0, n) makes its sample's candidates NaN
// and not ok), theta (512,) f32 (the plain version's grid), focal null or
// one f32 (then th = (err / focal)^2, else th = th_value); scratch cand
// (10 n5 + n8, 9) f32, cand_ok (10 n5 + n8,) bytes, quality (10 n5 + n8,)
// f32 (the candidates and their qualities, kept for checks), steps null
// or (10 n5,) bytes (each root's bisection steps up to its bracket's
// fixed point, 0 where a slot has no root); ticket one int32, 0 before
// the launch and after it (the wrapper's, one per stream); outputs out_e
// (3, 3) f32, out_inl (n,) bytes, out_n one int64.
extern "C" int essential_ransac_launch(const void* xl, const void* xr,
                                       const void* valid, int n,
                                       const void* idx5, int n5,
                                       const void* idx8, int n8,
                                       const void* theta, const void* focal,
                                       float err, float th_value, void* cand,
                                       void* cand_ok, void* quality,
                                       void* steps, void* ticket,
                                       void* out_e, void* out_inl,
                                       void* out_n, void* stream) {
  if (n < 1 || n5 < 0 || n8 < 0 || n5 + n8 < 1) return -1;
  Args a;
  a.xl = static_cast<const float*>(xl);
  a.xr = static_cast<const float*>(xr);
  a.valid = static_cast<const uint8_t*>(valid);
  a.n = n;
  a.idx5 = static_cast<const int64_t*>(idx5);
  a.n5 = n5;
  a.idx8 = static_cast<const int64_t*>(idx8);
  a.theta = static_cast<const float*>(theta);
  a.focal = static_cast<const float*>(focal);
  a.err = err;
  a.th_value = th_value;
  a.cand = static_cast<float*>(cand);
  a.cand_ok = static_cast<uint8_t*>(cand_ok);
  a.quality = static_cast<float*>(quality);
  a.steps = static_cast<uint8_t*>(steps);
  a.ticket = static_cast<int*>(ticket);
  a.out_e = static_cast<float*>(out_e);
  a.out_inl = static_cast<uint8_t*>(out_inl);
  a.out_n = static_cast<int64_t*>(out_n);
  essential_ransac_kernel<<<n5 + n8, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
