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
//   solvers/ba_invdepth.py::_bins, made once a solve): Hpp (Kw, Kw, 6, 6)
//   with the observer-anchor cross blocks (a warp a (pose, pose) bin) and
//   bp (Kw, 6) (a warp a pose): 32 entries at a time, a lane loading one
//   row's record and writing its products to shared memory, then a lane
//   an output adding them in order; Z (Lw, Kw, 6), Hrr and brho (Lw), a
//   thread an output; the cost on block 0.
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
// fixed tree. Two launches agree bit for bit. Against the plain version
// the per-row products round differently (torch's batched products, its
// CUB sum of the scalar landmark bins, its torch.sum of the cost), so the
// sums agree to round-off. Never build with --use_fast_math.
//
// Bound on an H100 SXM (roofline.py::ba_normal_eq_bound): the bytes, at
// slice B's local BA (Kw 32, Lw 4096, O 8192), ~5 MB (Z's 3.1 MB written
// in full, the lp bins' offsets, the sorted permutations), ~1.6 us; the
// f32 operations ~12 MFLOP, ~0.2 us. Bytes bind. The longest chain is
// the busiest pose bin's sequential sum (hundreds of entries for a
// keyframe observed by many rows): its loads go 32 entries at a time, its
// additions one after another.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowFloats = 32;
// the row record: J_obs (2x6), J_anch (2x6), J_rho (2), r (2), w, cost
constexpr int kJo = 0, kJa = 12, kJr = 24, kR = 26, kW = 28, kCost = 29;
constexpr int kRowThreads = 128;
constexpr int kSumThreads = 256;
constexpr int kWarpsPerBlock = kSumThreads / 32;
// a warp's tile of 32 entries' products (36 a (pose, pose) entry), rows
// padded to 37 floats so that a lane's row and its neighbour's fall in
// different banks
constexpr int kTileStride = 37;

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

// first block of each of ba_sums_kernel's sections (mode 0)
struct Sections {
  int pp, pose, lm, lp, end;
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

// sum of n values v[i * stride] over the block: a strided sum a thread,
// then a fixed tree; every thread returns it
__device__ float block_sum(const float* v, int stride, int n, float* sh) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kSumThreads)
    acc += v[static_cast<size_t>(i) * stride];
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

__global__ void __launch_bounds__(kSumThreads)
    ba_sums_kernel(const Args a, const Sections sec) {
  __shared__ float sh[kSumThreads];
  __shared__ float tiles[kWarpsPerBlock][32 * kTileStride];
  const int b = blockIdx.x;
  const float* rows = a.rows;
  const int O = a.O;
  if (b == 0) {
    // the cost; in mode 1 the accept test
    const float cost = block_sum(rows + (a.mode == 0 ? kCost : 0),
                                 a.mode == 0 ? kRowFloats : 1, O, sh);
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
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* tile = tiles[warp];
  if (b < sec.pose) {
    // Hpp: a warp a (pose, pose) bin. Its sorted entries come 32 at a
    // time, a lane each: the lane loads its row's record and writes the
    // entry's 36 products to the warp's tile; then lane j adds entry j of
    // the 6x6 block (lanes 0-3 also 32 + j) over the tile's rows in sorted
    // order, so each sum still runs one entry after another
    const int bin = (b - sec.pp) * kWarpsPerBlock + warp;
    if (bin >= a.Kw * a.Kw) return;
    const int e1 = 32 + (lane & 3);
    const int64_t beg = a.off_pp[bin], end = a.off_pp[bin + 1];
    float acc0 = 0.f, acc1 = 0.f;
    for (int64_t base = beg; base < end; base += 32) {
      const int n = static_cast<int>(end - base < 32 ? end - base : 32);
      if (lane < n) {
        int o;
        const int part = split<4>(static_cast<int>(a.perm_pp[base + lane]),
                                  O, o);           // oo, oa, ao, aa
        const float* R = rows + static_cast<size_t>(o) * kRowFloats;
        const float w = R[kW];
        const float* Jl = R + (part < 2 ? kJo : kJa);
        const float* Jt = R + ((part & 1) ? kJa : kJo);
        float l0[6], l1[6], t0[6], t1[6];
        for (int k = 0; k < 6; ++k) {
          l0[k] = Jl[k] * w;
          l1[k] = Jl[6 + k] * w;
          t0[k] = Jt[k];
          t1[k] = Jt[6 + k];
        }
        for (int k = 0; k < 6; ++k)
          for (int l = 0; l < 6; ++l)
            tile[lane * kTileStride + 6 * k + l] = l0[k] * t0[l]
                                                   + l1[k] * t1[l];
      }
      __syncwarp();
      for (int i = 0; i < n; ++i) {
        acc0 += tile[i * kTileStride + lane];
        acc1 += tile[i * kTileStride + e1];
      }
      __syncwarp();
    }
    a.Hpp[static_cast<size_t>(bin) * 36 + lane] = acc0;
    if (lane < 4) a.Hpp[static_cast<size_t>(bin) * 36 + e1] = acc1;
    return;
  }
  if (b < sec.lm) {
    // bp: a warp a pose, its entries 32 at a time as for Hpp, lanes 0-5
    // adding the tile's rows in sorted order
    const int k = (b - sec.pose) * kWarpsPerBlock + warp;
    if (k >= a.Kw) return;
    const int64_t beg = a.off_pose[k], end = a.off_pose[k + 1];
    float acc = 0.f;
    for (int64_t base = beg; base < end; base += 32) {
      const int n = static_cast<int>(end - base < 32 ? end - base : 32);
      if (lane < n) {
        int o;
        const int part = split<2>(static_cast<int>(a.perm_pose[base + lane]),
                                  O, o);           // observer, anchor
        const float* R = rows + static_cast<size_t>(o) * kRowFloats;
        const float w = R[kW];
        const float* J = R + (part ? kJa : kJo);
        for (int c = 0; c < 6; ++c)
          tile[lane * kTileStride + c] =
              -((J[c] * w) * R[kR] + (J[6 + c] * w) * R[kR + 1]);
      }
      __syncwarp();
      if (lane < 6)
        for (int i = 0; i < n; ++i) acc += tile[i * kTileStride + lane];
      __syncwarp();
    }
    if (lane < 6) a.bp[6 * k + lane] = acc;
    return;
  }
  if (b < sec.lp) {
    // Hrr, brho: a thread a landmark
    const int l = (b - sec.lm) * kSumThreads + threadIdx.x;
    if (l >= a.Lw) return;
    float h = 0.f, g = 0.f;
#pragma unroll 4
    for (int64_t e = a.off_lm[l]; e < a.off_lm[l + 1]; ++e) {
      const float* R = rows + static_cast<size_t>(a.perm_lm[e])
                              * kRowFloats;
      const float w = R[kW];
      const float wj0 = R[kJr] * w, wj1 = R[kJr + 1] * w;
      h += wj0 * R[kJr] + wj1 * R[kJr + 1];
      g += -(wj0 * R[kR] + wj1 * R[kR + 1]);
    }
    a.Hrr[l] = h;
    a.brho[l] = g;
    return;
  }
  // Z: a thread an entry (landmark, pose, component); most bins are empty
  const int t = (b - sec.lp) * kSumThreads + threadIdx.x;
  if (t >= a.Lw * a.Kw * 6) return;
  const int bin = t / 6, c = t % 6;
  float acc = 0.f;
  for (int64_t e = a.off_lp[bin]; e < a.off_lp[bin + 1]; ++e) {
    int o;
    const int part = split<2>(static_cast<int>(a.perm_lp[e]), O, o);
    const float* R = rows + static_cast<size_t>(o) * kRowFloats;
    const float w = R[kW];
    const float* J = R + (part ? kJa : kJo);
    acc += (J[c] * w) * R[kJr] + (J[6 + c] * w) * R[kJr + 1];
  }
  a.Z[t] = acc;
}

int blocks(long long n, int per) { return static_cast<int>((n + per - 1) / per); }

}  // namespace

// Launches mode a->mode (0: the normal equations, 1: the candidate's cost
// and the accept test) on ``stream``: ba_rows_kernel, then ba_sums_kernel.
// ``args`` points to an Args on the host. Returns 0, a cudaError_t, or -1
// for sizes the kernels do not take.
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
  Sections sec{1, 1, 1, 1, 1};
  if (a.mode == 0) {
    sec.pose = sec.pp + blocks(static_cast<long long>(a.Kw) * a.Kw,
                               kWarpsPerBlock);
    sec.lm = sec.pose + blocks(a.Kw, kWarpsPerBlock);
    sec.lp = sec.lm + blocks(a.Lw, kSumThreads);
    sec.end = sec.lp + blocks(6LL * a.Lw * a.Kw, kSumThreads);
  }
  ba_sums_kernel<<<sec.end, kSumThreads, 0, s>>>(a, sec);
  return static_cast<int>(cudaGetLastError());
}
