// Local BA's LM step around its two library calls (inverse-depth, dense
// Schur branch): the landmarks' elimination before the Schur product and
// the 6Kw solve, the back-substitution and the pose update after them.
//
// Replaces the XLA-compiled form of the LM step in
// ov2slam_tpu/solvers/ba_invdepth.py::_solve_iteration_inv after its sums:
// the damping (:421-427), Zn = Z / Hrr_d and b_schur (:430-432), the
// identity pad of fixed poses (:434-439) and the solve's layout with its
// 1e-6 I (:441-443), then the back-substitution (:446-448), the
// left-multiplicative pose update and the clamp of rho (:450-451). No
// Pallas kernel stands behind it. The plain PyTorch version is
// solvers/ba_invdepth.py::schur_step_plain; its wrapper schur_step runs
// mode 0, then S -= Zn^T Z (torch.addmm, f32, TF32 off: the product the
// JAX package leaves to an einsum), then torch.linalg.solve_ex (LU with
// partial pivoting, as jnp.linalg.solve), then mode 1.
//
// Mode 0 (prepare), schur_prepare_kernel, two sections:
//   - b (6Kw): bp - sum_l Zn[l] brho[l], times the pose's free flag, and
//     on the way Zn (Lw, Kw, 6) = Z / Hrr_d and Hrr_d = Hrr + lambda
//     max(Hrr, 1e-6) + 1e-8 (each rounding step as torch takes it). Each
//     output's sum is 32 chains, chain w over landmarks w, w + 32, ...,
//     the chains' sums added in chain order. A CTA of 512 threads takes 4
//     outputs (48 CTAs at Kw 32): all its threads compute a chunk of 1024
//     landmarks' products into shared memory, then 128 of them add their
//     chains' share of it while the rest go on to the next chunk;
//   - S (6Kw x 6Kw): Hpp with lambda max(diag, 1e-6) added to the
//     diagonal blocks' diagonals, zeroed where either pose is fixed, 1 on
//     a fixed pose's diagonal, and 1e-6 on the diagonal: the system before
//     the Schur product is subtracted (the plain version adds the pad and
//     the 1e-6 after subtracting it, so those entries round in another
//     order).
// Mode 1 (update), schur_step_kernel: a warp a landmark, d_rho = (brho -
//   Z[l] . dx) / Hrr_d (the lanes' strided sums, then a xor butterfly),
//   rho + d_rho clamped at 1e-6; a thread a pose, exp(dx free) * T_cw
//   (lie.py's se3_exp with its Taylor branches, then pose_compose).
//
// Rounding: no atomics, every sum in one fixed order; two launches agree
// bit for bit, and with this file's first build (one kernel, b on one
// CTA a tile of 32 outputs). Never build with --use_fast_math.
//
// Bound on an H100 SXM (roofline.py::ba_schur_step_bound), at slice B's
// local BA (Kw 32, Lw 4096): bytes, Z read twice over the two modes in
// the kernels but once in the bound, Zn and S written: ~6.5 MB, ~2 us;
// operations ~4 MFLOP. Bytes bind. The longest chain is a b chain's
// Lw / 32 landmarks one after another, then the 32 chains' sums
// (roofline.py::ba_schur_step_chain). Most of Z is zeros, and
// __fdiv_rn takes its slow path for a zero numerator: div_rn gives those
// quotients' zeros itself.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;           // the update's CTA
constexpr int kWarps = kThreads / 32;
constexpr int kPrepThreads = 512;        // the prepare's CTA
// b's partial sums: output j's chain w (0 .. kChains - 1) adds landmarks
// w, w + kChains, ...; a CTA of the prepare's b section holds the chains
// of kBOutputs outputs and stages their products kChunk landmarks at a
// time (kStaged a thread)
constexpr int kChains = 32;
constexpr int kBOutputs = 4;
constexpr int kChunk = 1024;
constexpr int kStaged = kChunk * kBOutputs / kPrepThreads;
static_assert(kChunk % kChains == 0 && kPrepThreads % kBOutputs == 0,
              "a chunk holds whole rounds of the chains");

// field for field solvers/ba_invdepth.py::SchurArgs
struct Args {
  const float* Hpp;      // (Kw, Kw, 6, 6)
  const float* bp;       // (Kw, 6)
  const float* Z;        // (Lw, Kw, 6)
  const float* Hrr;      // (Lw,)
  const float* brho;     // (Lw,)
  const float* lam;      // one f32
  const float* free;     // (Kw,)
  const float* T_cw;     // (Kw, 7)
  const float* rho;      // (Lw,)
  const float* dx;       // (6Kw,) mode 1: the solve's step
  float* S;              // (6Kw, 6Kw) mode 0 out
  float* Zn;             // (Lw, Kw, 6) mode 0 out
  float* Hrr_d;          // (Lw,) mode 0 out, mode 1 in
  float* b;              // (6Kw,) mode 0 out
  float* T_new;          // (Kw, 7) mode 1 out
  float* rho_new;        // (Lw,) mode 1 out
  int mode, Kw, Lw;
};

// Hrr + lambda max(Hrr, 1e-6) + 1e-8, rounded step by step as torch does
__device__ __forceinline__ float damped(float h, float lam) {
  return __fadd_rn(__fadd_rn(h, __fmul_rn(lam, fmaxf(h, 1e-6f))), 1e-8f);
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// lie.py's quat_rotate
__device__ __forceinline__ void quat_rotate(const float q[4],
                                            const float v[3], float o[3]) {
  const float qv[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  cross3(qv, v, uv);
  cross3(qv, uv, uuv);
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

// lie.py's pose_left_update: se3_exp(xi) * T, xi = [v | w]
__device__ void left_update(const float* T, const float xi[6], float* out) {
  const float* v = xi;
  const float* w = xi + 3;
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = th2 < 1e-8f;
  const float th = sqrtf(small ? 1.f : th2);
  float s_half, c_half, s_th, c_th;
  sincosf(0.5f * th, &s_half, &c_half);
  sincosf(th, &s_th, &c_th);
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
  float q[4], r[3];
  quat_mul(qe, T, q);
  quat_normalize(q);
  quat_rotate(qe, T + 4, r);
  for (int i = 0; i < 4; ++i) out[i] = q[i];
  for (int i = 0; i < 3; ++i) out[4 + i] = r[i] + te[i];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// z / hd as __fdiv_rn rounds it. A zero z over a finite nonzero hd is a
// zero with the sign of the two signs' product, given here: most of Z is
// zeros, and __fdiv_rn takes its slow path for a zero numerator.
__device__ __forceinline__ float div_rn(float z, float hd) {
  const unsigned mag = __float_as_uint(hd) & 0x7fffffffu;
  if (z == 0.f && mag != 0u && mag < 0x7f800000u)
    return __int_as_float((__float_as_int(z) ^ __float_as_int(hd))
                          & 0x80000000);
  return __fdiv_rn(z, hd);
}

// Mode 0. CTAs 0 .. nb - 1: b, with Zn and Hrr_d on the way, for
// outputs j0 .. j0 + kBOutputs - 1. The landmarks go kChunk at a time:
// every thread computes kStaged of the chunk's (landmark, output)
// products zn brho (zn = Z / Hrr_d, written to Zn), their loads issued
// together, into one of two shared buffers; after the CTA's barrier,
// thread (w, g), one of the first kChains * kBOutputs, adds output j0 +
// g's products of landmarks w, w + kChains, ... of that chunk in order
// (its chain's running sum carried over the chunks) while the others go
// on to the next chunk; the chains' sums are then added in chain order.
// The other CTAs: S before the product, an entry a thread.
__global__ void __launch_bounds__(kPrepThreads)
    schur_prepare_kernel(const Args p, int nb) {
  const int n = 6 * p.Kw;
  const float lam = p.lam[0];
  const int blk = blockIdx.x;
  if (blk < nb) {
    __shared__ float prod[2][kChunk][kBOutputs];
    __shared__ float part[kChains][kBOutputs];
    const int t = threadIdx.x, g = t % kBOutputs;
    const int j0 = blk * kBOutputs, j = j0 + g;
    const bool hrr = blk == 0 && g == 0;
    const bool chain = t < kChains * kBOutputs && j < n;
    float acc = 0.f;
    for (int L0 = 0, c = 0; L0 < p.Lw; L0 += kChunk, ++c) {
      const int m = p.Lw - L0 < kChunk ? p.Lw - L0 : kChunk;
      float(*buf)[kBOutputs] = prod[c & 1];
      float z[kStaged], h[kStaged], r[kStaged];
#pragma unroll
      for (int k = 0; k < kStaged; ++k) {
        const int i = (t + k * kPrepThreads) / kBOutputs, l = L0 + i;
        const bool ok = i < m && j < n;
        z[k] = ok ? __ldg(p.Z + static_cast<size_t>(l) * n + j) : 0.f;
        h[k] = ok ? __ldg(p.Hrr + l) : 0.f;
        r[k] = ok ? __ldg(p.brho + l) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kStaged; ++k) {
        const int i = (t + k * kPrepThreads) / kBOutputs, l = L0 + i;
        if (i < m && j < n) {
          const float hd = damped(h[k], lam);
          const float zn = div_rn(z[k], hd);
          p.Zn[static_cast<size_t>(l) * n + j] = zn;
          if (hrr) p.Hrr_d[l] = hd;
          buf[i][g] = __fmul_rn(zn, r[k]);
        }
      }
      __syncthreads();
      if (chain) {
        const int w = t / kBOutputs;
        if (m == kChunk) {
          constexpr int kSteps = kChunk / kChains;
          float v[kSteps];
#pragma unroll
          for (int k = 0; k < kSteps; ++k) v[k] = buf[w + k * kChains][g];
#pragma unroll
          for (int k = 0; k < kSteps; ++k) acc = __fadd_rn(acc, v[k]);
        } else {
          for (int i = w; i < m; i += kChains)
            acc = __fadd_rn(acc, buf[i][g]);
        }
      }
    }
    if (t < kChains * kBOutputs) part[t / kBOutputs][g] = acc;
    __syncthreads();
    if (t < kBOutputs && j < n) {
      float s = 0.f;
      for (int c = 0; c < kChains; ++c) s = __fadd_rn(s, part[c][g]);
      p.b[j] = __fmul_rn(__fsub_rn(p.bp[j], s), p.free[j / 6]);
    }
    return;
  }
  // S before the product: damped, masked, padded, 1e-6 I
  const int t = (blk - nb) * kPrepThreads + threadIdx.x;
  if (t >= n * n) return;
  const int i = t / n, j = t % n;
  const int k = i / 6, a = i % 6, q = j / 6, bb = j % 6;
  float h = p.Hpp[((static_cast<size_t>(k) * p.Kw + q) * 6 + a) * 6 + bb];
  const bool diag = k == q && a == bb;
  if (diag) h = __fadd_rn(h, __fmul_rn(lam, fmaxf(h, 1e-6f)));
  const bool fk = p.free[k] > 0.f, fq = p.free[q] > 0.f;
  float v = (fk && fq) ? h : 0.f;
  if (diag) v = __fadd_rn(v, fk ? 0.f : 1.f);
  if (i == j) v = __fadd_rn(v, 1e-6f);
  p.S[t] = v;
}

// Mode 1: CTAs 0 .. nb - 1 a warp a landmark, then a thread a pose
__global__ void __launch_bounds__(kThreads)
    schur_step_kernel(const Args p, int nb) {
  const int n = 6 * p.Kw;
  const int blk = blockIdx.x;
  if (blk < nb) {
    // the inverse depths: a warp a landmark
    const int l = blk * kWarps + threadIdx.x / 32;
    if (l >= p.Lw) return;
    const int lane = threadIdx.x & 31;
    const float* z = p.Z + static_cast<size_t>(l) * n;
    float acc = 0.f;
    for (int j = lane; j < n; j += 32) acc += z[j] * p.dx[j];
    const float corr = warp_sum(acc);
    if (lane == 0) {
      const float d = __fdiv_rn(__fsub_rn(p.brho[l], corr), p.Hrr_d[l]);
      p.rho_new[l] = fmaxf(__fadd_rn(p.rho[l], d), 1e-6f);
    }
    return;
  }
  // the poses: a thread a pose
  const int k = (blk - nb) * kThreads + threadIdx.x;
  if (k >= p.Kw) return;
  float xi[6];
  for (int c = 0; c < 6; ++c) xi[c] = p.dx[6 * k + c] * p.free[k];
  left_update(p.T_cw + 7 * k, xi, p.T_new + 7 * k);
}

int blocks(long long n, int per) { return static_cast<int>((n + per - 1) / per); }

}  // namespace

// Launches mode args->mode (0: prepare, 1: update) on ``stream``; ``args``
// points to an Args on the host. Returns 0, a cudaError_t, or -1 for sizes
// the kernel does not take.
extern "C" int ba_schur_step_launch(const void* args, void* stream) {
  const Args p = *static_cast<const Args*>(args);
  if (p.Kw < 1 || p.Kw > 64 || p.Lw < 1 || (p.mode != 0 && p.mode != 1)
      || 6LL * p.Lw * p.Kw >= (1LL << 31))
    return -1;
  const long long n = 6LL * p.Kw;
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.mode == 0) {
    const int nb = blocks(n, kBOutputs);
    schur_prepare_kernel<<<nb + blocks(n * n, kPrepThreads), kPrepThreads,
                           0, s>>>(p, nb);
  } else {
    const int nb = blocks(p.Lw, kWarps);
    const int grid = nb + blocks(p.Kw, kThreads);
    schur_step_kernel<<<grid, kThreads, 0, s>>>(p, nb);
  }
  return static_cast<int>(cudaGetLastError());
}
