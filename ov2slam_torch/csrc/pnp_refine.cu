// Motion-only PnP: the pose-only Levenberg-Marquardt loop in one launch.
//
// Replaces the XLA-compiled form of ov2slam_tpu/solvers/pnp_refine.py:45
// pnp_refine (_pose_residuals :24; pnp_refine_two_pass :113 is two
// launches), which the JAX package fuses into its jitted tracking step. No
// Pallas kernel stands behind it. The plain PyTorch version is
// solvers/pnp_refine.py::pnp_refine_plain; this kernel computes what it
// computes, one CTA over the N rows:
//
//   the pose centred on its own translation (T_cw = inverse([q, 0]), the
//   points less the centre); then `iters` times:
//   - the residuals and 2x6 Jacobians of every row (_pose_residuals: z
//     clamped to 1e-3 in magnitude, depth_ok = z > 1e-3), Huber weights
//     (robust_th > 0) or ones, w = valid * w_rob * depth_ok;
//   - H (21 unique entries) and g reduced in a fixed order, the Huber or L2
//     cost beside them;
//   - Hd = H + lam diag(max(diag H, 1e-6)) + 1e-8 I solved by a 6x6 LU
//     with partial pivoting, T_new = exp(dx) * T_cw (lie.py's se3_exp with
//     its Taylor branches, then pose_compose);
//   - accept = c1 < c0, lam x0.5 (floor 1e-8) or x4 (ceiling 1e2).
//   After the loop the chi2 gate (robust_th, or 5.9915 for L2):
//   inlier = valid & chi2 <= gate & depth_ok; T_out = inverse(T_cw) with the
//   centre added back, and c1.
//
// One pass over the rows per iteration. The plain version computes H, g
// and c0 at T_cw and then c1 at T_new; here a pass at T_new computes c1
// together with H, g at T_new: if the step is accepted they are the next
// iteration's H, g and c0 (the same arithmetic at the same pose), and if it
// is rejected T_cw is unchanged and so are H, g and c0. So the kernel takes
// iters + 2 passes where the plain version takes 2 iters + 1, with the
// same result.
//
// Rounding. Each thread sums its rows in index order, then a xor
// reduce-scatter of shuffles (offsets 16, 8, 4, 2, 1: at each a lane keeps
// half of its values and sends the other half, so every sum is paired as
// in a full butterfly and lane k ends with sum k) and the warps in order:
// no atomics, so two launches agree bit for bit. The result is also the
// earlier one-thread form's of this file bit for bit (28 full butterflies,
// the solve and the exponential on thread 0): the solve keeps its
// operations element by element, with the contractions ptxas made there
// written out as fused multiply-adds. Against the plain version the sums
// and the 6x6 solve round in another order (its reductions are torch's,
// its LU LAPACK's or cuSOLVER's), so the pose agrees to round-off and an
// acceptance test c1 < c0 near convergence may go the other way (a step
// of the order of the round-off). Never build with --use_fast_math.
//
// Bound on an H100 SXM. Per row and pass ~240 FLOP (the projection, the
// Jacobian and its 27 products into H and g, the cost): at the front end's
// call (N = 512, 10 iterations) ~1.4 MFLOP, 0.00002 ms at 67 TFLOP/s; the
// bytes (points, pixels, masks, once) ~11 KB, 0.000003 ms
// (roofline.py::pnp_refine_bound). Neither binds: each iteration is a
// dependent chain of a pass, a block reduction of 28 sums, a 6x6 solve and
// the exponential, so the call takes at least (iters + 2) x that chain.
//
// Design. One CTA of 256 threads; the pose in shared memory, every row's
// work in registers. Warp 0 sums the warps' partial sums, takes the
// accept decision of the last candidate and solves for the next one, each
// of its lanes alike with the 6x7 system in registers (row swaps by
// selects: the one-thread form's dynamic swap put it in local memory);
// lane 1 takes the exponential's sine and cosine of the full angle while
// the others take the half angle's. Two barriers an iteration. A solve
// with lanes 0-5 a row each (pivot, swap and pivot row by shuffles) kept
// the bits too, but measured slower on the card than this one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVals = 28;        // 21 entries of H, 6 of g, the cost

struct Params {
  const float* T_wc;
  const float* pts;
  const float* px;
  const uint8_t* valid;
  const float* cal_ptr[4];       // fx, fy, cx, cy on the device, or null
  float cal_val[4];              // ... else these
  int n, pts_stride, px_stride, iters;
  float robust_th, lam0;
  float* out_T;
  uint8_t* out_inl;
  float* out_cost;
};

struct Pose {
  float q[4];   // w, x, y, z
  float t[3];
};

__device__ __forceinline__ void cross(const float a[3], const float b[3],
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
  cross(qv, v, uv);
  cross(qv, uv, uuv);
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.f * (q[0] * uv[i] + uuv[i]);
}

__device__ __forceinline__ void quat_normalize(float q[4]) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

__device__ __forceinline__ void quat_mul(const float a[4], const float b[4],
                                         float o[4]) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// lie.py's pose_inverse: (conj q, -rotate(conj q, t))
__device__ void pose_inverse(const Pose& T, Pose& o) {
  o.q[0] = T.q[0];
  o.q[1] = -T.q[1];
  o.q[2] = -T.q[2];
  o.q[3] = -T.q[3];
  float r[3];
  quat_rotate(o.q, T.t, r);
  for (int i = 0; i < 3; ++i) o.t[i] = -r[i];
}

// lie.py's se3_exp(xi) * T (pose_left_update), xi = [v | w], by every
// lane of a warp alike (the same xi on each): lane 0 takes the sine and
// cosine of th / 2, lane 1 those of th, and each pair goes to every lane,
// so that every lane computes the same pose
__device__ void left_update(const Pose& T, const float xi[6], Pose& o,
                            int lane) {
  const float* v = xi;
  const float* w = xi + 3;
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = th2 < 1e-8f;
  const float th = sqrtf(small ? 1.f : th2);
  float s_lane, c_lane;
  sincosf(lane == 1 ? th : 0.5f * th, &s_lane, &c_lane);
  const float s_half = __shfl_sync(0xffffffffu, s_lane, 0);
  const float c_half = __shfl_sync(0xffffffffu, c_lane, 0);
  const float s_th = __shfl_sync(0xffffffffu, s_lane, 1);
  const float c_th = __shfl_sync(0xffffffffu, c_lane, 1);
  const float k = small ? 0.5f - th2 / 48.f : s_half / th;
  float qe[4] = {small ? 1.f - th2 / 8.f : c_half, k * w[0], k * w[1],
                 k * w[2]};
  quat_normalize(qe);
  // the left Jacobian V = I + A W + B W^2, W = hat(w)
  const float A = small ? 0.5f - th2 / 24.f : (1.f - c_th) / (th * th);
  const float B = small ? 1.f / 6.f - th2 / 120.f
                        : (th - s_th) / (th * th * th);
  const float W[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]},
                         {-w[1], w[0], 0.f}};
  float te[3];
  for (int i = 0; i < 3; ++i) {
    float acc = 0.f;
    for (int j = 0; j < 3; ++j) {
      float w2 = 0.f;
      for (int m = 0; m < 3; ++m) w2 += W[i][m] * W[m][j];
      const float Vij = (i == j ? 1.f : 0.f) + A * W[i][j] + B * w2;
      acc += Vij * v[j];
    }
    te[i] = acc;
  }
  // pose_compose(exp, T): q = normalize(qe qT), t = rotate(qe, tT) + te
  quat_mul(qe, T.q, o.q);
  quat_normalize(o.q);
  float r[3];
  quat_rotate(qe, T.t, r);
  for (int i = 0; i < 3; ++i) o.t[i] = r[i] + te[i];
}

struct Cal {
  float fx, fy, cx, cy;
};

// one row at pose T: accumulates w J^T J, w J^T r and the cost into acc
// (when acc is given) and returns chi2 and depth_ok
__device__ __forceinline__ float row_terms(const Pose& T, const float P[3],
                                           float ox, float oy, bool valid,
                                           const Cal& cal, float robust_th,
                                           float* acc, bool& dok) {
  float p[3];
  quat_rotate(T.q, P, p);
  for (int i = 0; i < 3; ++i) p[i] += T.t[i];
  const float x = p[0], y = p[1], z = p[2];
  dok = z > 1e-3f;
  const float zs = fabsf(z) < 1e-3f ? 1e-3f : z;
  const float r0 = (cal.fx * x / zs + cal.cx) - ox;
  const float r1 = (cal.fy * y / zs + cal.cy) - oy;
  const float chi2 = r0 * r0 + r1 * r1;
  if (acc == nullptr) return chi2;
  const bool robust = robust_th > 0.f;
  float w_rob = 1.f, rho = chi2;
  if (robust) {
    if (chi2 > robust_th) {
      w_rob = sqrtf(robust_th / fmaxf(chi2, 1e-12f));
      rho = 2.f * sqrtf(robust_th * chi2) - robust_th;
    }
  }
  const float wv = valid ? 1.f : 0.f;
  const float wd = dok ? 1.f : 0.f;
  const float w = wv * w_rob * wd;
  acc[27] += rho * wv * wd;
  if (w == 0.f) return chi2;
  const float iz = 1.f / zs;
  const float a = cal.fx * iz, b = -cal.fx * x * iz * iz;
  const float c = cal.fy * iz, d = -cal.fy * y * iz * iz;
  // [Jproj | -Jproj hat(p)], hat(p) = [[0,-z,y],[z,0,-x],[-y,x,0]]
  const float J[2][6] = {
      {a, 0.f, b, -(b * -y), -(a * -z + b * x), -(a * y)},
      {0.f, c, d, -(c * z + d * -y), -(d * x), -(c * -x)}};
  int u = 0;
  for (int k = 0; k < 6; ++k)
    for (int l = k; l < 6; ++l, ++u)
      acc[u] += w * (J[0][k] * J[0][l] + J[1][k] * J[1][l]);
  const float wr0 = w * r0, wr1 = w * r1;
  for (int k = 0; k < 6; ++k) acc[21 + k] += J[0][k] * wr0 + J[1][k] * wr1;
  return chi2;
}

// one step of the reduce-scatter at xor offset O: v[0 .. 2 O) in, v[0 .. O)
// out; a lane with bit O keeps the upper half
template <int O>
__device__ __forceinline__ void scatter_step(float* v, int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float keep = upper ? v[O + j] : v[j];
    const float send = upper ? v[j] : v[O + j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// every thread's rows at pose T, each warp's sums into red[warp] (lane k
// < kVals writes sum k), then a barrier
__device__ void pass(const Params& p, const Cal& cal, const float* center,
                     const Pose& T, float (*red)[kVals]) {
  float acc[kVals];
#pragma unroll
  for (int v = 0; v < kVals; ++v) acc[v] = 0.f;
  for (int i = threadIdx.x; i < p.n; i += kThreads) {
    const float* P = p.pts + static_cast<size_t>(i) * p.pts_stride;
    const float* o = p.px + static_cast<size_t>(i) * p.px_stride;
    const float Pc[3] = {P[0] - center[0], P[1] - center[1],
                         P[2] - center[2]};
    bool dok;
    row_terms(T, Pc, o[0], o[1], p.valid[i] != 0, cal, p.robust_th, acc,
              dok);
  }
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = k < kVals ? acc[k] : 0.f;
  const int lane = threadIdx.x & 31;
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  if (lane < kVals) red[threadIdx.x / 32][lane] = v[0];
  __syncthreads();
}

// sum ``lane`` (< kVals) over the warps in order; by warp 0
__device__ __forceinline__ float warp_sums(const float (*red)[kVals],
                                           int lane) {
  float s = 0.f;
  if (lane < kVals)
    for (int w = 0; w < kWarps; ++w) s += red[w][lane];
  return s;
}

// (H + lam diag(max(diag H, 1e-6)) + 1e-8 I) dx = g by LU with partial
// pivoting (the first largest pivot, multipliers by the reciprocal), on
// every lane of warp 0 alike, the system in registers (row swaps by
// selects): lane k < kVals holds sum k (H's 21 entries, then g's 6 and the
// cost); dx on every lane
__device__ void solve6(float sums, float lam, float dx[6]) {
  float a[6][7];
  int u = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j, ++u)
      a[i][j] = a[j][i] = __shfl_sync(0xffffffffu, sums, u);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    // (a + lam * max(a, 1e-6)) + 1e-8: ptxas fuses the first product
    a[i][i] = __fadd_rn(__fmaf_rn(lam, fmaxf(a[i][i], 1e-6f), a[i][i]),
                        1e-8f);
    a[i][6] = -__shfl_sync(0xffffffffu, sums, 21 + i);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(a[k][k]);
#pragma unroll
    for (int r = k + 1; r < 6; ++r)
      if (fabsf(a[r][k]) > best) {
        best = fabsf(a[r][k]);
        p = r;
      }
#pragma unroll
    for (int r = k + 1; r < 6; ++r)
      if (r == p)
#pragma unroll
        for (int c = 0; c < 7; ++c) {
          const float t = a[k][c];
          a[k][c] = a[r][c];
          a[r][c] = t;
        }
    const float rcp = __frcp_rn(a[k][k]);
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      const float l = __fmul_rn(a[r][k], rcp);
      a[r][k] = l;
#pragma unroll
      for (int c = k + 1; c < 7; ++c)
        a[r][c] = __fmaf_rn(-l, a[k][c], a[r][c]);
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    float b = a[k][6];
#pragma unroll
    for (int c = k + 1; c < 6; ++c) b = __fmaf_rn(-a[k][c], dx[c], b);
    dx[k] = __fdiv_rn(b, a[k][k]);
  }
}

__global__ void __launch_bounds__(kThreads) pnp_refine_kernel(const Params p) {
  __shared__ float red[kWarps][kVals];
  __shared__ Pose s_T[2];          // T_cw, the candidate
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Cal cal;
  cal.fx = p.cal_ptr[0] ? *p.cal_ptr[0] : p.cal_val[0];
  cal.fy = p.cal_ptr[1] ? *p.cal_ptr[1] : p.cal_val[1];
  cal.cx = p.cal_ptr[2] ? *p.cal_ptr[2] : p.cal_val[2];
  cal.cy = p.cal_ptr[3] ? *p.cal_ptr[3] : p.cal_val[3];
  const float center[3] = {p.T_wc[4], p.T_wc[5], p.T_wc[6]};
  if (threadIdx.x == 0) {
    Pose Tw;
    for (int i = 0; i < 4; ++i) Tw.q[i] = p.T_wc[i];
    for (int i = 0; i < 3; ++i) Tw.t[i] = p.T_wc[4 + i] - center[i];
    pose_inverse(Tw, s_T[0]);
  }
  __syncthreads();
  pass(p, cal, center, s_T[0], red);
  // warp 0's: lane k holds sum k of H, g and the cost at T_cw
  float cur = warp == 0 ? warp_sums(red, lane) : 0.f;
  float lam = p.lam0, c1 = 0.f;
  for (int it = 0; it <= p.iters; ++it) {
    if (warp == 0) {
      if (it > 0) {   // the last candidate's sums: keep it if it is cheaper
        const float nxt = warp_sums(red, lane);
        c1 = __shfl_sync(0xffffffffu, nxt, kVals - 1);
        const bool accept = c1 < __shfl_sync(0xffffffffu, cur, kVals - 1);
        if (accept) {
          if (lane == 0) s_T[0] = s_T[1];
          cur = nxt;
          lam = fmaxf(lam * 0.5f, 1e-8f);
        } else {
          lam = fminf(lam * 4.f, 1e2f);
        }
      }
      if (it < p.iters) {
        float dx[6];
        solve6(cur, lam, dx);
        Pose next;
        left_update(s_T[0], dx, next, lane);
        if (lane == 0) s_T[1] = next;
      }
    }
    __syncthreads();
    if (it == p.iters) break;
    pass(p, cal, center, s_T[1], red);
  }
  const float gate = p.robust_th > 0.f ? p.robust_th : 5.9915f;
  const Pose T = s_T[0];
  for (int i = threadIdx.x; i < p.n; i += kThreads) {
    const float* P = p.pts + static_cast<size_t>(i) * p.pts_stride;
    const float* o = p.px + static_cast<size_t>(i) * p.px_stride;
    const float Pc[3] = {P[0] - center[0], P[1] - center[1],
                         P[2] - center[2]};
    bool dok;
    const float chi2 = row_terms(T, Pc, o[0], o[1], false, cal, 0.f,
                                 nullptr, dok);
    p.out_inl[i] = p.valid[i] && chi2 <= gate && dok;
  }
  if (threadIdx.x == 0) {
    Pose Ti;
    pose_inverse(T, Ti);
    for (int i = 0; i < 4; ++i) p.out_T[i] = Ti.q[i];
    for (int i = 0; i < 3; ++i) p.out_T[4 + i] = Ti.t[i] + center[i];
    p.out_cost[0] = c1;
  }
}

}  // namespace

// Launches on ``stream``; returns 0, a cudaError_t, or -1 for arguments the
// kernel is not sized for. Device pointers: T_wc (7,) f32, pts (n, 3) and
// px (n, 2) f32 with the floats of a row adjacent and rows pts_stride,
// px_stride floats apart, valid (n,) bytes; out_T (7,) f32, out_inl (n,)
// bytes, out_cost one f32. Host arrays: cal_ptrs (4 device pointers, fx,
// fy, cx, cy, each f32 or 0) and cal_vals (4 floats, taken where the
// pointer is 0).
extern "C" int pnp_refine_launch(const void* T_wc, const void* pts,
                                 int pts_stride, const void* px,
                                 int px_stride, const void* valid, int n,
                                 const void* cal_ptrs, const void* cal_vals,
                                 float robust_th, int iters, float lam0,
                                 void* out_T, void* out_inl, void* out_cost,
                                 void* stream) {
  if (n < 1 || pts_stride < 3 || px_stride < 2 || iters < 0) return -1;
  Params p{};
  p.T_wc = static_cast<const float*>(T_wc);
  p.pts = static_cast<const float*>(pts);
  p.px = static_cast<const float*>(px);
  p.valid = static_cast<const uint8_t*>(valid);
  const auto* cp = static_cast<const int64_t*>(cal_ptrs);
  const auto* cv = static_cast<const float*>(cal_vals);
  for (int i = 0; i < 4; ++i) {
    p.cal_ptr[i] = reinterpret_cast<const float*>(cp[i]);
    p.cal_val[i] = cv[i];
  }
  p.n = n;
  p.pts_stride = pts_stride;
  p.px_stride = px_stride;
  p.iters = iters;
  p.robust_th = robust_th;
  p.lam0 = lam0;
  p.out_T = static_cast<float*>(out_T);
  p.out_inl = static_cast<uint8_t*>(out_inl);
  p.out_cost = static_cast<float*>(out_cost);
  pnp_refine_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
