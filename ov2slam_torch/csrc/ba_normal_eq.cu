// Local BA's normal equations (inverse-depth, dense Schur branch): every
// observation row's reprojection and Jacobians, and their sums by bin.
//
// Replaces the XLA-compiled form of ov2slam_tpu/solvers/ba_invdepth.py's
// _residuals_jacobians_inv (:104), the weights and cost0 of
// ba_solve_invdepth's iter_body (:490-507), the accumulation part of
// _solve_iteration_inv (:346-420: the one-hot GEMMs "on the MXU" for every
// pose-indexed sum) and, in the cost mode, _total_cost_inv (:165) with the
// LM accept test (:508-516). No Pallas kernel stands behind it. The plain
// PyTorch versions are solvers/ba_invdepth.py::normal_equations_plain and
// lm_accept_plain; this file computes what they compute.
//
// Mode 0 (normal equations), two kernels:
//   ba_rows_kernel, a thread a row o: the landmark's world point through
//   its anchor's inverse depth (rho clamped at 1e-6, the anchor's measured
//   ray), the observer's camera point, the right camera through T_rl,
//   depth_ok = z > 1e-3 (z clamped to 1e-3 in magnitude), the residual,
//   the analytic 2x6 observer and anchor Jacobians and the 2x1 rho one;
//   chi2, the Huber IRLS weight (robust_th > 0) or 1, w = w_valid w_rob
//   depth_ok, the robust cost w_valid depth_ok rho(chi2), and the gauge
//   (each pose Jacobian times its pose's free flag). It writes a record
//   of 32 floats a row.
//   ba_sums_kernel: every sum the plain version takes with
//   torch.segment_reduce over the rows sorted by bin (the stable sorts of
//   solvers/ba_invdepth.py::_bins, made once a solve), each from 0, one
//   entry after another in that order. CTA 0 takes the cost. Then a CTA
//   a (pose, pose) bin of Hpp (Kw, Kw, 6, 6, with the observer-anchor
//   cross blocks) or pose bin of bp (Kw, 6), the diagonal (pose, pose)
//   bins first, then the pose bins: they are the longest, and (k, k)
//   holds at least as many entries as (k, q) or pose k. In it, six warps
//   produce each round of 32 entries' products into a ring of tiles in
//   shared memory and two only add them, so that a sum's chain is one
//   shared load and one addition an entry (bin_sum). Then a warp a
//   landmark for Z (Lw, Kw, 6), Hrr and brho (Lw): the landmark's entries
//   32 at a time, a lane an entry's products, a lane a bin adding them
//   (landmark_sums). Then the other (pose, pose) bins.
// Mode 1 (cost and accept), two kernels: ba_rows_kernel writes each row's
//   robust cost at the candidate state; ba_sums_kernel on one block sums
//   them and keeps the candidate (T_cw, rho) where its cost is below cost0
//   (lambda halved, floor 1e-6), else the current state (lambda x4,
//   ceiling 1e2).
//
// Rows that are not valid (weight 0) are in no bin: _bins sorts them past
// the last one, so a window's padding rows (index -1 clamped to 0) do not
// make one bin thousands of entries long.
//
// Rounding. No atomics: each output is summed by one thread in the bins'
// stable-sorted order, as torch.segment_reduce sums its segments (from 0,
// one row after another); the cost over the rows by a strided sum and a
// fixed tree. Every product pair rounds as a * b + c * d was contracted
// by this file's first build (c d, then one fused multiply-add: pair()),
// so the redesign gives that build's bits. Two launches agree bit for
// bit. Against the plain version the per-row products round differently
// (torch's batched products, its CUB sum of the scalar landmark bins,
// its torch.sum of the cost), so the sums agree to round-off. Never
// build with --use_fast_math.
//
// Bound on an H100 SXM (roofline.py::ba_normal_eq_bound): the bytes, at
// slice B's local BA (Kw 32, Lw 4096, O 8192), ~3.6 MB (Z's 3.1 MB
// written in full), ~1.1 us; the f32 operations ~12 MFLOP, ~0.2 us.
// Bytes bind. The longest chain is the busiest bin's sum, one addition
// an entry (roofline.py::ba_normal_eq_chain): slice B's (7, 7) bin holds
// 2610 entries, ~5 us at 4 cycles an addition.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowFloats = 32;
// the row record: J_obs (2x6), J_anch (2x6), J_rho (2), r (2), w, cost
constexpr int kJo = 0, kJa = 12, kJr = 24, kR = 26, kW = 28, kCost = 29;
constexpr int kRowThreads = 128;
constexpr int kSumThreads = 256;
constexpr int kWarpsPerBlock = kSumThreads / 32;
// a bin's CTA: warps 0 and 1 add, the other 6 produce, through a ring of
// kRing tiles of 32 entries' products (36 a (pose, pose) entry, 6 a pose
// entry), stored by output: output c's 32 products at c * kTileStride,
// so that an adding lane reads its 32 in eight 16-byte loads (a row of 36
// floats puts 8 lanes' loads in different banks). An adding warp waits
// for kGroup tiles at once. 41.5 KB.
constexpr int kAdders = 2;
constexpr int kProducers = kWarpsPerBlock - kAdders;
constexpr int kRing = 8;
constexpr int kGroup = 4;
static_assert(kGroup <= kRing, "an adding warp holds kGroup tiles");
constexpr int kTileStride = 36;
constexpr int kTileFloats = 36 * kTileStride;
// a landmark warp's shared floats: its tile of 32 entries' 6 products
// (rows of 7: a lane's and its neighbour's in different banks), then its
// row of Z (Kw <= 64)
constexpr int kPoseStride = 7;
constexpr int kLandmarkFloats = 32 * kPoseStride + 64 * 6;
static_assert(kWarpsPerBlock * kLandmarkFloats <= kRing * kTileFloats,
              "the landmark warps' tiles share the ring's memory");

// field for field solvers/ba_invdepth.py::NormalEqArgs
struct Args {
  const float* T_cw;          // (Kw, 7) the state (mode 1: the candidate)
  const float* rho;           // (Lw,)
  const int64_t* anchor;      // (Lw,) in [0, Kw)
  const float* ray;           // (Lw, 2)
  const int64_t* obs_kf;      // (O,) in [0, Kw)
  const int64_t* obs_lm;      // (O,) in [0, Lw)
  const float* obs_px;        // (O, 2)
  const uint8_t* right;       // (O,) bool
  const float* w_valid;       // (O,)
  const float* free;          // (Kw,) mode 0
  const float* fx;            // one f32 each
  const float* fy;
  const float* cx;
  const float* cy;
  const float* T_rl;          // (7,)
  const int64_t* perm_pose;   // mode 0: each bin index's stable sort
  const int64_t* perm_lm;
  const int64_t* perm_pp;
  const int64_t* perm_lp;
  const int64_t* off_pose;    // ... and each bin's first sorted entry
  const int64_t* off_lm;
  const int64_t* off_pp;
  const int64_t* off_lp;
  const float* T_cur;         // mode 1: the current state, lambda, cost0
  const float* rho_cur;
  const float* lam;
  const float* cost0;
  float* rows;                // scratch: (O, 32) mode 0, (O,) mode 1
  float* Hpp;                 // mode 0 outputs
  float* bp;
  float* Z;
  float* Hrr;
  float* brho;
  float* cost;                // both modes
  float* T_out;               // mode 1 outputs
  float* rho_out;
  float* lam_out;
  int mode, Kw, Lw, O;
  float robust_th;
};

struct Cal {
  float fx, fy, cx, cy;
  float q_rl[4], t_rl[3];
  float R_rl[3][3];
};

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// lie.py's quat_rotate: v + 2 (qw (qv x v) + qv x (qv x v))
__device__ __forceinline__ void quat_rotate(const float q[4],
                                            const float v[3], float o[3]) {
  const float qv[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  cross3(qv, v, uv);
  cross3(qv, uv, uuv);
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.f * (q[0] * uv[i] + uuv[i]);
}

// lie.py's quat_to_matrix
__device__ __forceinline__ void quat_matrix(const float q[4],
                                            float R[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1.f - 2.f * (yy + zz);
  R[0][1] = 2.f * (xy - wz);
  R[0][2] = 2.f * (xz + wy);
  R[1][0] = 2.f * (xy + wz);
  R[1][1] = 1.f - 2.f * (xx + zz);
  R[1][2] = 2.f * (yz - wx);
  R[2][0] = 2.f * (xz - wy);
  R[2][1] = 2.f * (yz + wx);
  R[2][2] = 1.f - 2.f * (xx + yy);
}

// hat(p) = [[0, -p2, p1], [p2, 0, -p0], [-p1, p0, 0]]
__device__ __forceinline__ void hat(const float p[3], float H[3][3]) {
  H[0][0] = 0.f;   H[0][1] = -p[2]; H[0][2] = p[1];
  H[1][0] = p[2];  H[1][1] = 0.f;   H[1][2] = -p[0];
  H[2][0] = -p[1]; H[2][1] = p[0];  H[2][2] = 0.f;
}

__device__ Cal load_cal(const Args& a) {
  Cal c;
  c.fx = *a.fx;
  c.fy = *a.fy;
  c.cx = *a.cx;
  c.cy = *a.cy;
  for (int i = 0; i < 4; ++i) c.q_rl[i] = a.T_rl[i];
  for (int i = 0; i < 3; ++i) c.t_rl[i] = a.T_rl[4 + i];
  quat_matrix(c.q_rl, c.R_rl);
  return c;
}

// Row o at the state: its residual and depth flag, and with ``jac`` its
// Jacobians (solvers/ba_invdepth.py::_project_inv and
// _residuals_jacobians_inv, operation for operation). Returns depth_ok.
__device__ bool row_terms(const Args& a, const Cal& c, int o, bool jac,
                          float r[2], float Jo[2][6], float Ja[2][6],
                          float Jr[2], int64_t& k_obs, int64_t& k_anch) {
  const int64_t l = a.obs_lm[o];
  const int64_t k = a.obs_kf[o];
  const int64_t an = a.anchor[l];
  k_obs = k;
  k_anch = an;
  const float rho_c = fmaxf(a.rho[l], 1e-6f);
  const float m[3] = {a.ray[2 * l], a.ray[2 * l + 1], 1.f};
  const float pa[3] = {m[0] / rho_c, m[1] / rho_c, m[2] / rho_c};
  // T_wc_a = pose_inverse(T_cw[anchor]) = (conj q, -rotate(conj q, t))
  const float* Ta = a.T_cw + 7 * an;
  const float qi[4] = {Ta[0], -Ta[1], -Ta[2], -Ta[3]};
  float ti[3], Xw[3];
  quat_rotate(qi, Ta + 4, ti);
  quat_rotate(qi, pa, Xw);
  for (int i = 0; i < 3; ++i) Xw[i] = Xw[i] + -ti[i];
  // the observer's camera point, then the right camera's
  const float* Tk = a.T_cw + 7 * k;
  float pl[3];
  quat_rotate(Tk, Xw, pl);
  for (int i = 0; i < 3; ++i) pl[i] = pl[i] + Tk[4 + i];
  const bool is_right = a.right[o] != 0;
  float pc[3];
  if (is_right) {
    quat_rotate(c.q_rl, pl, pc);
    for (int i = 0; i < 3; ++i) pc[i] = pc[i] + c.t_rl[i];
  } else {
    for (int i = 0; i < 3; ++i) pc[i] = pl[i];
  }
  const float x = pc[0], y = pc[1], z = pc[2];
  const bool dok = z > 1e-3f;
  const float zs = fabsf(z) < 1e-3f ? 1e-3f : z;
  r[0] = (c.fx * x / zs + c.cx) - a.obs_px[2 * o];
  r[1] = (c.fy * y / zs + c.cy) - a.obs_px[2 * o + 1];
  if (!jac) return dok;

  const float iz = 1.f / zs;
  const float Jp[2][3] = {{c.fx * iz, 0.f, -c.fx * x * iz * iz},
                          {0.f, c.fy * iz, -c.fy * y * iz * iz}};
  // d r / d p_left = Jproj (R_rl for the right camera)
  float Jpi[2][3];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 3; ++j) {
      if (is_right) {
        float s = 0.f;
        for (int q = 0; q < 3; ++q) s += Jp[i][q] * c.R_rl[q][j];
        Jpi[i][j] = s;
      } else {
        Jpi[i][j] = Jp[i][j];
      }
    }
  // observer: [Jpi | -Jpi hat(p_left)]
  float H[3][3];
  hat(pl, H);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 3; ++j) {
      float s = 0.f;
      for (int q = 0; q < 3; ++q) s += Jpi[i][q] * H[q][j];
      Jo[i][j] = Jpi[i][j];
      Jo[i][3 + j] = -s;
    }
  // d r / d X_w = Jpi R_cw(observer)
  float Rk[3][3], JX[2][3];
  quat_matrix(Tk, Rk);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 3; ++j) {
      float s = 0.f;
      for (int q = 0; q < 3; ++q) s += Jpi[i][q] * Rk[q][j];
      JX[i][j] = s;
    }
  // anchor: -J_Xw R_wc_a [I | -hat(p_anch)]
  float Ra[3][3], Ha[3][3], M[3][6];
  quat_matrix(qi, Ra);
  hat(pa, Ha);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float s = 0.f;
      for (int q = 0; q < 3; ++q) s += Ra[i][q] * -Ha[q][j];
      M[i][j] = Ra[i][j];
      M[i][3 + j] = s;
    }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 6; ++j) {
      float s = 0.f;
      for (int q = 0; q < 3; ++q) s += JX[i][q] * M[q][j];
      Ja[i][j] = -s;
    }
  // rho: J_Xw (-(R_wc_a p_anch) / rho)
  float d[3];
  for (int i = 0; i < 3; ++i) {
    float s = 0.f;
    for (int q = 0; q < 3; ++q) s += Ra[i][q] * pa[q];
    d[i] = -s / rho_c;
  }
  for (int i = 0; i < 2; ++i) {
    float s = 0.f;
    for (int q = 0; q < 3; ++q) s += JX[i][q] * d[q];
    Jr[i] = s;
  }
  return dok;
}

__global__ void __launch_bounds__(kRowThreads) ba_rows_kernel(const Args a) {
  const int o = blockIdx.x * kRowThreads + threadIdx.x;
  if (o >= a.O) return;
  const Cal c = load_cal(a);
  const bool jac = a.mode == 0;
  float r[2], Jo[2][6], Ja[2][6], Jr[2];
  int64_t k_obs, k_anch;
  const bool dok = row_terms(a, c, o, jac, r, Jo, Ja, Jr, k_obs, k_anch);
  const float chi2 = r[0] * r[0] + r[1] * r[1];
  const float th = a.robust_th;
  float w_rob = 1.f, rho_l = chi2;
  if (th > 0.f && !(chi2 <= th)) {
    w_rob = sqrtf(th / fmaxf(chi2, 1e-12f));
    rho_l = 2.f * sqrtf(th * fmaxf(chi2, 0.f)) - th;
  }
  const float wv = a.w_valid[o];
  const float wd = dok ? 1.f : 0.f;
  const float cost = rho_l * wv * wd;
  if (!jac) {
    a.rows[o] = cost;
    return;
  }
  const float w = wv * w_rob * wd * wd;
  const float f_obs = a.free[k_obs], f_anch = a.free[k_anch];
  float rec[kRowFloats];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 6; ++j) {
      rec[kJo + 6 * i + j] = Jo[i][j] * f_obs;
      rec[kJa + 6 * i + j] = Ja[i][j] * f_anch;
    }
  rec[kJr] = Jr[0];
  rec[kJr + 1] = Jr[1];
  rec[kR] = r[0];
  rec[kR + 1] = r[1];
  rec[kW] = w;
  rec[kCost] = cost;
  rec[30] = rec[31] = 0.f;
  float4* dst = reinterpret_cast<float4*>(a.rows + static_cast<size_t>(o)
                                          * kRowFloats);
  for (int i = 0; i < kRowFloats / 4; ++i)
    dst[i] = make_float4(rec[4 * i], rec[4 * i + 1], rec[4 * i + 2],
                         rec[4 * i + 3]);
}

// sum of n values v[i * stride] over the block: a strided sum a thread
// (its loads eight at a time, its additions one after another), then a
// fixed tree; every thread returns it
__device__ float block_sum(const float* v, int stride, int n, float* sh) {
  float acc = 0.f;
  int i = threadIdx.x;
  for (; i + 7 * kSumThreads < n; i += 8 * kSumThreads) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = v[static_cast<size_t>(i + u * kSumThreads) * stride];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += x[u];
  }
  for (; i < n; i += kSumThreads) acc += v[static_cast<size_t>(i) * stride];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

// which of the concatenated row sets (0 .. parts - 1) entry ``ent`` of a
// bin index is in, and its row
template <int parts>
__device__ __forceinline__ int split(int ent, int O, int& o) {
  int part = ent >= O;
  if (parts == 4) part += (ent >= 2 * O) + (ent >= 3 * O);
  o = ent - part * O;
  return part;
}

// a b + c d as every product pair of the sums rounds: c d rounded, then
// one fused multiply-add (what this file's first build contracted the
// expression a * b + c * d to)
__device__ __forceinline__ float pair(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, __fmul_rn(c, d));
}

// row o's record, all 32 floats (its 128 bytes, one line), into registers
__device__ __forceinline__ void load_rec(const float* rows, int o,
                                         float (&f)[kRowFloats]) {
  const float4* R = reinterpret_cast<const float4*>(
      rows + static_cast<size_t>(o) * kRowFloats);
#pragma unroll
  for (int i = 0; i < kRowFloats / 4; ++i) {
    const float4 v = __ldg(R + i);
    f[4 * i] = v.x;
    f[4 * i + 1] = v.y;
    f[4 * i + 2] = v.z;
    f[4 * i + 3] = v.w;
  }
}

// A producer lane's entry: for a (pose, pose) bin J_l (the observer's
// Jacobian for the oo and oa parts, 0 and 1, the anchor's otherwise), J_t
// (the observer's for oo and ao, 0 and 2) and w; for a pose bin J (the
// observer's for part 0, the anchor's for 1), r and w.
constexpr int kEnt = 25;
constexpr int kEl = 0, kEt = 12, kEw = 24;       // (pose, pose)
constexpr int kEr = 12, kEpw = 14;               // pose

// the 36 products w J_l^T J_t of a (pose, pose) entry, product c at dst[c
// * kTileStride]
__device__ __forceinline__ void pp_products(const float (&f)[kEnt],
                                            float* dst) {
  const float w = f[kEw];
  float l0[6], l1[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    l0[k] = __fmul_rn(f[kEl + k], w);
    l1[k] = __fmul_rn(f[kEl + 6 + k], w);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int l = 0; l < 6; ++l)
      dst[(6 * k + l) * kTileStride] = pair(l0[k], f[kEt + l], l1[k],
                                            f[kEt + 6 + l]);
}

// the 6 products -(w J^T r) of a pose entry, as pp_products places them
__device__ __forceinline__ void pose_products(const float (&f)[kEnt],
                                              float* dst) {
  const float w = f[kEpw];
#pragma unroll
  for (int c = 0; c < 6; ++c)
    dst[c * kTileStride] = -pair(__fmul_rn(f[c], w), f[kEr],
                                 __fmul_rn(f[6 + c], w), f[kEr + 1]);
}

// the permutation index of lane's entry in round r of a bin, or -1
__device__ __forceinline__ int entry(const int64_t* perm, int64_t beg,
                                     int64_t end, int r, int rounds,
                                     int lane) {
  const int64_t e = beg + 32LL * r + lane;
  return r < rounds && e < end ? static_cast<int>(perm[e]) : -1;
}

// A bin CTA's tiles are handed over by counters in shared memory:
// full[s] is one more than the last round written to tile s, and each
// adding warp's empty[c][s] one more than the last round it added from
// it. They only grow, so a wait compares and can never take an older use
// of a tile for the one it waits for.

// waits until *flag >= v (an acquire once a fence follows)
__device__ __forceinline__ void wait_for(const int* flag, int v) {
  while (*reinterpret_cast<const volatile int*>(flag) < v) {
  }
}

// waits until rounds g .. g_end - 1 (at most kGroup) are all written:
// their counters read together, then a fence (an acquire)
__device__ __forceinline__ void wait_group(const int* full, int g,
                                           int g_end) {
  const volatile int* f = full;
  bool ready;
  do {
    ready = true;
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      if (g + q < g_end) ready &= f[(g + q) % kRing] > g + q;
  } while (!ready);
  __threadfence_block();
}

// issues the loads of entry ``ent``'s floats (see kEnt) from its row's
// record into f; returns its part
template <bool kPP>
__device__ __forceinline__ int fetch(const Args& a, int ent,
                                     float (&f)[kEnt]) {
  int o;
  const int part = split<kPP ? 4 : 2>(ent, a.O, o);
  const float* R = a.rows + static_cast<size_t>(o) * kRowFloats;
  const float4* l = reinterpret_cast<const float4*>(
      R + ((kPP ? part < 2 : part == 0) ? kJo : kJa));
  const float4* t = reinterpret_cast<const float4*>(
      R + ((part & 1) ? kJa : kJo));
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float4 v = __ldg(l + q);
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
    if (kPP) {
      const float4 u = __ldg(t + q);
      f[kEt + 4 * q] = u.x;
      f[kEt + 4 * q + 1] = u.y;
      f[kEt + 4 * q + 2] = u.z;
      f[kEt + 4 * q + 3] = u.w;
    }
  }
  if (kPP) {
    f[kEw] = __ldg(R + kW);
  } else {
    f[kEr] = __ldg(R + kR);
    f[kEr + 1] = __ldg(R + kR + 1);
    f[kEpw] = __ldg(R + kW);
  }
  return part;
}

// a producer warp's round r: waits for the round's tile to be free (round
// r - kRing added by every adding warp), writes each lane's entry's
// products to it (part < 0: no entry), then publishes it (the warp's
// barrier orders every lane's stores before lane 0's fence and flag: a
// release)
template <bool kPP>
__device__ __forceinline__ void produce(int r, const float (&f)[kEnt],
                                        int part, float* ring, int* full,
                                        int* empty) {
  const int slot = r % kRing;
  if (r >= kRing) {
    wait_for(empty + slot, r - kRing + 1);
    if (kPP) wait_for(empty + kRing + slot, r - kRing + 1);
    __threadfence_block();
  }
  if (part >= 0) {
    float* dst = ring + slot * kTileFloats + (threadIdx.x & 31);
    if (kPP)
      pp_products(f, dst);
    else
      pose_products(f, dst);
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();
    *reinterpret_cast<volatile int*>(full + slot) = r + 1;
  }
}

// the 32 products of output e in a tile, as eight 16-byte loads
__device__ __forceinline__ void load_row(const float* tile, int e,
                                         float4 (&v)[8]) {
  const float4* t = reinterpret_cast<const float4*>(tile + e * kTileStride);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = t[q];
}

__device__ __forceinline__ float add_row(const float4 (&v)[8], float acc) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    acc += v[q].x;
    acc += v[q].y;
    acc += v[q].z;
    acc += v[q].w;
  }
  return acc;
}

// acc plus output e's products of kGroup full tiles from round g on, one
// after another; each tile's loads go out before the tile before it is
// added
__device__ __forceinline__ float add_group(const float* ring, int g, int e,
                                           float acc) {
  float4 v[2][8];
  load_row(ring + (g % kRing) * kTileFloats, e, v[0]);
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    if (q + 1 < kGroup)
      load_row(ring + ((g + q + 1) % kRing) * kTileFloats, e, v[(q + 1) & 1]);
    acc = add_row(v[q & 1], acc);
  }
  return acc;
}

// acc plus the first n (1..32) products of output e of a tile, one after
// another
__device__ __forceinline__ float add_part(const float* tile, int e, int n,
                                          float acc) {
  const float* row = tile + e * kTileStride;
  for (int i = 0; i < n; ++i) acc += row[i];
  return acc;
}

// The sum of one (pose, pose) bin (36 outputs) or pose bin (6), on a CTA
// of 8 warps. Its sorted entries go in rounds of 32 through a ring of
// kRing tiles. Warps 2-7 produce: warp p takes rounds p - 2, p + 4, ...,
// its lane i loading entry i's permutation index two of its rounds ahead
// and row record one ahead (two register buffers in turn, so that no
// round waits on a load it issued), then writing the entry's products to
// the round's tile. Warps 0 and 1 only add: lane j of warp 0 output j
// (pose bins: j < 6), lane j < 4 of warp 1 output 32 + j, over each
// tile's products in order, so that every output is still summed from 0
// one entry after another in the bins' sorted order, and the chain is one
// addition an entry. An adding warp takes kGroup tiles at a time (one
// wait, one fence, one release for all of them).
template <bool kPP>
__device__ void bin_sum(const Args& a, int bin, int64_t beg, int64_t end,
                        float* ring, int* full, int* empty) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int64_t* perm = kPP ? a.perm_pp : a.perm_pose;
  const int rounds = static_cast<int>((end - beg + 31) / 32);
  if (threadIdx.x < kRing)
    full[threadIdx.x] = empty[threadIdx.x] = empty[kRing + threadIdx.x] = 0;
  __syncthreads();
  if (warp >= kAdders) {
    int r = warp - kAdders;
    if (r >= rounds) return;
    float fa[kEnt], fb[kEnt];
    int pa = -1, pb = -1;
    int ent = entry(perm, beg, end, r, rounds, lane);
    if (ent >= 0) pa = fetch<kPP>(a, ent, fa);
    ent = entry(perm, beg, end, r + kProducers, rounds, lane);
    while (true) {
      produce<kPP>(r, fa, pa, ring, full, empty);
      pb = ent >= 0 ? fetch<kPP>(a, ent, fb) : -1;
      ent = entry(perm, beg, end, r + 2 * kProducers, rounds, lane);
      r += kProducers;
      if (r >= rounds) break;
      produce<kPP>(r, fb, pb, ring, full, empty);
      pa = ent >= 0 ? fetch<kPP>(a, ent, fa) : -1;
      ent = entry(perm, beg, end, r + 2 * kProducers, rounds, lane);
      r += kProducers;
      if (r >= rounds) break;
    }
    return;
  }
  if (!kPP && warp == 1) return;        // a pose bin has one adding warp
  const int e = kPP ? warp * 32 + (warp ? lane & 3 : lane) : lane % 6;
  const int64_t n_all = end - beg;
  float acc = 0.f;
  for (int g = 0; g < rounds; g += kGroup) {
    const int g_end = g + kGroup < rounds ? g + kGroup : rounds;
    wait_group(full, g, g_end);
    if (n_all - 32LL * g >= 32 * kGroup) {
      acc = add_group(ring, g, e, acc);
    } else {
      for (int r = g; r < g_end; ++r) {
        const int64_t left = n_all - 32LL * r;
        acc = add_part(ring + (r % kRing) * kTileFloats, e,
                       left < 32 ? static_cast<int>(left) : 32, acc);
      }
    }
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      for (int r = g; r < g_end; ++r)
        *reinterpret_cast<volatile int*>(empty + warp * kRing + r % kRing) =
            r + 1;
    }
  }
  float* out = kPP ? a.Hpp + static_cast<size_t>(bin) * 36
                   : a.bp + static_cast<size_t>(bin) * 6;
  if (warp == 0 ? lane < (kPP ? 32 : 6) : lane < 4) out[e] = acc;
}

// Z (Kw, 6), Hrr and brho of landmark l, on one warp. The landmark's
// (landmark, pose) bins lie next to each other in the sorted order, so
// the warp walks all their entries 32 at a time: lane i computes entry
// i's 6 products into the warp's shared tile, then lane k adds those of
// its bin (l, k) (and lane k - 32's of (l, k + 32)) in order. Hrr and
// brho likewise over the landmark's rows, lanes 0 and 1 adding. The row
// of Z goes out through shared memory in 8-byte stores.
__device__ void landmark_sums(const Args& a, int l, float* sh) {
  const int lane = threadIdx.x & 31;
  const int Kw = a.Kw, O = a.O;
  float* tile = sh;                        // 32 x kPoseStride
  float* row = sh + 32 * kPoseStride;      // Kw x 6, 8-byte aligned
  // Hrr, brho
  float hg = 0.f;
  const int64_t mb = a.off_lm[l], me = a.off_lm[l + 1];
  for (int64_t base = mb; base < me; base += 32) {
    const int64_t e = base + lane;
    if (e < me) {
      float f[kRowFloats];
      load_rec(a.rows, static_cast<int>(a.perm_lm[e]), f);
      const float w = f[kW];
      const float wj0 = __fmul_rn(f[kJr], w), wj1 = __fmul_rn(f[kJr + 1], w);
      tile[lane * 2] = pair(wj0, f[kJr], wj1, f[kJr + 1]);
      tile[lane * 2 + 1] = -pair(wj0, f[kR], wj1, f[kR + 1]);
    }
    __syncwarp();
    const int n = static_cast<int>(me - base < 32 ? me - base : 32);
    if (lane < 2)
      for (int i = 0; i < n; ++i) hg += tile[i * 2 + lane];
    __syncwarp();
  }
  if (lane == 0) a.Hrr[l] = hg;
  if (lane == 1) a.brho[l] = hg;
  // Z
  const int64_t* off = a.off_lp + static_cast<size_t>(l) * Kw;
  int64_t kb[2], ke[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = lane + 32 * h;
    kb[h] = k < Kw ? off[k] : 0;
    ke[h] = k < Kw ? off[k + 1] : 0;
  }
  float acc[2][6];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[h][c] = 0.f;
  const int64_t zb = off[0], ze = off[Kw];
  for (int64_t base = zb; base < ze; base += 32) {
    const int64_t e = base + lane;
    if (e < ze) {
      int o;
      const int part = split<2>(static_cast<int>(a.perm_lp[e]), O, o);
      float f[kRowFloats];
      load_rec(a.rows, o, f);
      const float w = f[kW];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const float j0 = part ? f[kJa + c] : f[kJo + c];
        const float j1 = part ? f[kJa + 6 + c] : f[kJo + 6 + c];
        tile[lane * kPoseStride + c] = pair(__fmul_rn(j0, w), f[kJr],
                                            __fmul_rn(j1, w), f[kJr + 1]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t lo = kb[h] > base ? kb[h] : base;
      const int64_t hi = ke[h] < base + 32 ? ke[h] : base + 32;
      for (int64_t i = lo; i < hi; ++i)
#pragma unroll
        for (int c = 0; c < 6; ++c)
          acc[h][c] += tile[(i - base) * kPoseStride + c];
    }
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (lane + 32 * h < Kw)
#pragma unroll
      for (int c = 0; c < 6; ++c) row[(lane + 32 * h) * 6 + c] = acc[h][c];
  __syncwarp();
  float2* dst = reinterpret_cast<float2*>(a.Z + static_cast<size_t>(l)
                                          * Kw * 6);
  const float2* src = reinterpret_cast<const float2*>(row);
  for (int i = lane; i < Kw * 3; i += 32) dst[i] = src[i];
}

__global__ void __launch_bounds__(kSumThreads)
    ba_sums_kernel(const Args a) {
  __shared__ __align__(16) float sh[kRing * kTileFloats];
  __shared__ int flags[(1 + kAdders) * kRing];
  const int b = blockIdx.x;
  const float* rows = a.rows;
  if (b == 0) {
    // the cost; in mode 1 the accept test
    const float cost = block_sum(rows + (a.mode == 0 ? kCost : 0),
                                 a.mode == 0 ? kRowFloats : 1, a.O, sh);
    if (a.mode == 0) {
      if (threadIdx.x == 0) a.cost[0] = cost;
      return;
    }
    const bool accept = cost < a.cost0[0];
    for (int i = threadIdx.x; i < a.Kw * 7; i += kSumThreads)
      a.T_out[i] = accept ? a.T_cw[i] : a.T_cur[i];
    for (int i = threadIdx.x; i < a.Lw; i += kSumThreads)
      a.rho_out[i] = accept ? a.rho[i] : a.rho_cur[i];
    if (threadIdx.x == 0) {
      const float lam = a.lam[0];
      a.lam_out[0] = accept ? fmaxf(lam * 0.5f, 1e-6f)
                            : fminf(lam * 4.f, 1e2f);
      a.cost[0] = cost;
    }
    return;
  }
  // CTAs 1 .. 2Kw: the diagonal (pose, pose) bins, the longest ((k, q)
  // holds at most as many entries as (k, k)), then the pose bins; then a
  // CTA for every 8 landmarks; then the other (pose, pose) bins
  const int Kw = a.Kw, n_lm = (a.Lw + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int t = b - 1;
  if (t >= 2 * Kw && t < 2 * Kw + n_lm) {
    const int warp = threadIdx.x / 32;
    const int l = (t - 2 * Kw) * kWarpsPerBlock + warp;
    if (l < a.Lw) landmark_sums(a, l, sh + warp * kLandmarkFloats);
    return;
  }
  bool pp = true;
  int bin;
  if (t < Kw) {
    bin = t * Kw + t;
  } else if (t < 2 * Kw) {
    pp = false;
    bin = t - Kw;
  } else {
    const int j = t - 2 * Kw - n_lm, k = j / (Kw - 1), c = j % (Kw - 1);
    bin = k * Kw + c + (c >= k);
  }
  const int64_t* off = pp ? a.off_pp : a.off_pose;
  const int64_t beg = off[bin], end = off[bin + 1];
  if (beg == end) {
    if (threadIdx.x < (pp ? 36 : 6))
      (pp ? a.Hpp + static_cast<size_t>(bin) * 36
          : a.bp + static_cast<size_t>(bin) * 6)[threadIdx.x] = 0.f;
    return;
  }
  if (pp)
    bin_sum<true>(a, bin, beg, end, sh, flags, flags + kRing);
  else
    bin_sum<false>(a, bin, beg, end, sh, flags, flags + kRing);
}

int blocks(long long n, int per) { return static_cast<int>((n + per - 1) / per); }

}  // namespace

// Launches mode a->mode (0: the normal equations, 1: the candidate's cost
// and the accept test) on ``stream``: ba_rows_kernel, then ba_sums_kernel
// (mode 0: one CTA for the cost, one a (pose, pose) or pose bin, one for
// every 8 landmarks; mode 1: one CTA). ``args`` points to an Args on the
// host. Returns 0, a cudaError_t, or -1 for sizes the kernels do not
// take.
extern "C" int ba_normal_eq_launch(const void* args, void* stream) {
  const Args a = *static_cast<const Args*>(args);
  if (a.Kw < 1 || a.Kw > 64 || a.Lw < 1 || a.O < 0
      || (a.mode != 0 && a.mode != 1)
      || 4LL * a.O >= (1LL << 31)
      || 6LL * a.Lw * a.Kw >= (1LL << 31))
    return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.O > 0)
    ba_rows_kernel<<<blocks(a.O, kRowThreads), kRowThreads, 0, s>>>(a);
  const int grid = a.mode == 0 ? 1 + a.Kw * a.Kw + a.Kw
                                     + blocks(a.Lw, kWarpsPerBlock)
                               : 1;
  ba_sums_kernel<<<grid, kSumThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
