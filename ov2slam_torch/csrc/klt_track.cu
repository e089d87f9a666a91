// Pyramidal (forward-backward) Lucas-Kanade tracking, one launch per call.
//
// Replaces the XLA-compiled form of ov2slam_tpu/ops/klt.py: track_level's
// jax.lax.fori_loop of Gauss-Newton steps over the patch GEMMs of
// ov2slam_tpu/ops/patch.py (extract_patches, sample_window), inside the
// jitted klt_track and fb_klt_track. No Pallas kernel stands behind it. The
// plain PyTorch versions are ops/klt.py::klt_track_plain and
// fb_klt_track_plain; this kernel computes what they compute:
//
//   per keypoint, coarse to fine over L levels (flow starts at
//   (prior - kp) / 2^(L-1), doubles between levels, kp_l = kp / 2^l):
//   - a (win+2)^2 template sampled bilinearly at kp_l - (r+1) (hat weights,
//     rows first, 0 outside the image), central-difference Ix, Iy, the 2x2
//     gradient matrix G, its min eigenvalue gate and inverse;
//   - an integer-aligned search patch of S = win + 2 margin at
//     floor(kp_l + flow) - r - margin, 0 outside the image;
//   - up to `iters` steps: the window resampled inside the patch at the
//     offset clamped to [0, S - win], the two sums of gradient x residual,
//     the step applied while the row is alive, has a good G and has not
//     converged; converged once dx^2 + dy^2 < eps^2 (that step applied);
//   - after the level: the in-image test of the unclamped centre and the
//     residual mean |I - T| at the clamped final offset.
//   status = alive & residual < max_err. With back_levels > 0 (fb mode) the
//   same warp then tracks the forward result back over the first
//   back_levels levels toward kp, seeded with the forward status, and the
//   status becomes st_f & st_b & |bwd - kp| <= max_fb_dist.
//
// Rounding. Every elementwise operation (the template, G and its gate, the
// inverse, each step's resample, residual and update, the in-image test,
// the level residual) uses round-to-nearest intrinsics in the plain
// version's order (no FMA contraction); only the sums over window pixels
// run in another fixed order (each lane's pixels, then a 5-level xor
// butterfly of shuffles, no atomics), so the kernel agrees with the plain
// version to round-off and two launches agree bit for bit. Never build
// this file with --use_fast_math.
//
// Why the step resamples the window. A step's sums are linear in four
// integer-offset correlations of the gradients with the search patch, so
// a per-level table of them makes a step constant-time (8 table reads, no
// resample, no shuffle: 184-186 cycles a step against 883-893 on the
// H100). That form rounds differently from the plain version, and rows
// whose G is ill-conditioned amplify the difference (pixels apart on a
// few rows of slice A's run); slice A's loop then ends in another mode of
// its post-closure loose BA, past the endpoint gate, at chip_smoke's seed.
// The step keeps the plain version's arithmetic until the slices' gates
// hold for a table form (PERF.md, the KLT kernel's findings).
//
// Bound on an H100 SXM. Per keypoint and level pass ~2.5 kFLOP outside the
// steps (template, G) and ~1.06 kFLOP per step (win 9): entry()'s call
// (256 keypoints, 4 + 1 passes, 30 steps) is 46.9 MFLOP, 0.0007 ms at 67
// TFLOP/s, and reads ~1.3 MB of pixels, 0.0004 ms at 3.35 TB/s
// (roofline.py::fb_klt_bound). Neither binds: a keypoint's levels and
// steps are a dependent chain, so the call takes at least its longest
// keypoint's passes x one level's setup plus its steps x one step's
// latency (roofline.py::KLT_SETUP_CYCLES, KLT_CHAIN_CYCLES, measured with
// one keypoint).
//
// Design. One warp per keypoint, four per CTA: the steps of one keypoint
// are sequential, the keypoints independent.
//  - Copies by cp.async, 4 bytes a pixel (a level's row pitch need not be
//    a multiple of 16 bytes: 94 px at level 3 of 752; TMA is not used),
//    out-of-image pixels zero-filled by a source size of 0. Each pass
//    first issues the template source blocks of all its levels ((win+3)^2
//    integer pixels at floor(kp_l - r - 1), from which the bilinear
//    template is computed in shared memory) beside its top level's search
//    patch; each later level issues its patch (it depends on the flow)
//    before computing its template, and waits once before its steps.
//  - The search patch has one zero row and column past its end, so that
//    the bilinear taps of a window at the clamped edge (weight 0) read 0
//    without a clamp.
//  - A step: each lane resamples its pixels (4 shared loads each; kPix a
//    lane, a template parameter, 3 at win 9), the two sums reduce with the
//    butterfly, and every lane applies the 2x2 update redundantly, so no
//    broadcast is needed.
//  - A row that has converged, is dead or has a bad G stops stepping (warp-
//    uniform exit): the plain version's fixed `iters` steps leave such a
//    row's flow unchanged, so the result is the same.
//  - The level images come as a table of pointers and sizes (at most
//    kMaxLevels, a __grid_constant__ parameter indexed in place).
// wgmma does not apply: the work is tiny and sequential.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxWin = 15;
constexpr int kMaxMargin = 8;
constexpr int kWarps = 4;                          // keypoints per CTA

struct Levels {
  const float* img[2][kMaxLevels];   // [0] prev (template), [1] cur (search)
  int h[2][kMaxLevels];
  int w[2][kMaxLevels];
};

// a warp's shared memory, in floats from its base (each part 16-byte
// aligned): the template blocks of every level, the search patch and the
// template
struct Layout {
  int blk, sp, tpl, warp_floats;
};

struct Params {
  int levels, back_levels, n, kps_stride, priors_stride, win, iters, margin;
  float eps2, min_eig_th, max_err, max_fb;
  Layout lay;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// an integer-valued float as an int, far outside any image when huge
__device__ __forceinline__ int to_int(float f) {
  return static_cast<int>(clamp(f, -1073741824.f, 1073741824.f));
}

struct Hat {
  int i0;
  float w0, w1;
};

// ops/patch.py::_hat_pair: floor, weight of floor, weight of floor + 1
__device__ __forceinline__ Hat hat(float pos) {
  const float f = floorf(pos);
  Hat h;
  h.i0 = to_int(f);
  h.w0 = clamp_lo(sub(1.f, fabsf(sub(f, pos))), 0.f);
  h.w1 = clamp_lo(sub(1.f, fabsf(sub(add(f, 1.f), pos))), 0.f);
  return h;
}

// one pixel of ``img`` (H x W) at (y, x) into shared memory, 0 outside
__device__ __forceinline__ void copy_px(float* dst, const float* img, int H,
                                        int W, int y, int x) {
  const bool in = y >= 0 && y < H && x >= 0 && x < W;
  const float* src = in ? img + static_cast<size_t>(y) * W + x : img;
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this lane's committed copy groups are pending
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// (row, column) of q = lane, lane + 32, ... over a grid ``w`` wide, one
// division at the start and none a step
struct Walk {
  int i, j, di, dj, w;
  __device__ __forceinline__ Walk(int lane, int width)
      : i(lane / width), j(lane % width), di(32 / width), dj(32 % width),
        w(width) {}
  __device__ __forceinline__ void next() {
    i += di;
    j += dj;
    if (j >= w) {
      j -= w;
      ++i;
    }
  }
};

struct Window {      // ops/patch.py::sample_window's weights at one offset
  int base;          // patch index of the window's top-left tap
  float wy0, wy1, wx0, wx1;
};

__device__ __forceinline__ Window window_at(float offx, float offy,
                                            float shifts, int SP) {
  const Hat hx = hat(clamp(offx, 0.f, shifts));
  const Hat hy = hat(clamp(offy, 0.f, shifts));
  return Window{hy.i0 * SP + hx.i0, hy.w0, hy.w1, hx.w0, hx.w1};
}

__device__ __forceinline__ float window_px(const float* sp, int SP,
                                           const Window& w, int idx) {
  const float* p = sp + w.base + idx;
  const float r0 = add(mul(w.wy0, p[0]), mul(w.wy1, p[SP]));
  const float r1 = add(mul(w.wy0, p[1]), mul(w.wy1, p[SP + 1]));
  return add(mul(r0, w.wx0), mul(r1, w.wx1));
}

// issues the (win+3)^2 source block of level l's template at
// floor(kp_l - r - 1) into blk; returns nothing, the copies are pending
__device__ __forceinline__ void issue_block(float* blk, const float* A,
                                            int H, int W, float klx,
                                            float kly, int r, int BP,
                                            int lane) {
  const int x0 = to_int(floorf(sub(klx, static_cast<float>(r + 1))));
  const int y0 = to_int(floorf(sub(kly, static_cast<float>(r + 1))));
  Walk rc(lane, BP);
  for (int q = lane; q < BP * BP; q += 32, rc.next())
    copy_px(blk + q, A, H, W, y0 + rc.i, x0 + rc.j);
}

// klt_track_plain's level loop for one keypoint, its warp's lanes together:
// lv.img[a][l] is level l's template image, lv.img[1 - a][l] its search
// image. Updates the flow (at the top level's scale on entry, level-0 px on
// return), alive and the step count; returns the last level's residual.
template <int kPix>
__device__ float track(const Levels& lv, int a, int L, const Params& p,
                       float kx, float ky, float& fx, float& fy, bool& alive,
                       int& steps, float* sm) {
  const int lane = threadIdx.x & 31;
  const int win = p.win, r = win / 2, P = win + 2, npx = win * win;
  const int BP = P + 1;                    // template source block side
  const int S = win + 2 * p.margin, SP = S + 1;
  const float shifts = static_cast<float>(S - win);
  float* blk = sm + p.lay.blk;
  float* sp = sm + p.lay.sp;
  float* tpl = sm + p.lay.tpl;
  float residual = 0.f;
  // each lane's window pixels: template index and patch offset
  int tidx[kPix], pidx[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int q = lane + 32 * k;
    const int i = q / win, j = q - (q / win) * win;
    tidx[k] = (i + 1) * P + (j + 1);
    pidx[k] = i * SP + j;
  }
  __syncwarp();   // the previous pass's readers are done with blk
  for (int l = 0; l < L; ++l) {
    const float scale = static_cast<float>(1 << l);
    issue_block(blk + l * BP * BP, lv.img[a][l], lv.h[a][l], lv.w[a][l],
                __fdiv_rn(kx, scale), __fdiv_rn(ky, scale), r, BP, lane);
  }
  copy_commit();
  for (int l = L - 1; l >= 0; --l) {
    const float scale = static_cast<float>(1 << l);
    const float klx = __fdiv_rn(kx, scale), kly = __fdiv_rn(ky, scale);
    const int HA = lv.h[a][l], WA = lv.w[a][l];
    const float* B = lv.img[1 - a][l];
    const int HB = lv.h[1 - a][l], WB = lv.w[1 - a][l];

    // search patch at floor(kp_l + flow) - r - margin (integer-aligned: an
    // exact copy), with a zero row and column past its end
    const float bx = sub(sub(floorf(add(klx, fx)), static_cast<float>(r)),
                         static_cast<float>(p.margin));
    const float by = sub(sub(floorf(add(kly, fy)), static_cast<float>(r)),
                         static_cast<float>(p.margin));
    const int bxi = to_int(bx), byi = to_int(by);
    __syncwarp();   // the previous level's readers are done with sp, tpl
    Walk rc(lane, SP);
    for (int q = lane; q < SP * SP; q += 32, rc.next())
      copy_px(sp + q, B, HB, WB, (rc.i < S && rc.j < S) ? byi + rc.i : -1,
              bxi + rc.j);
    copy_commit();

    // template at kp_l - (r + 1) from the level's block (rows first)
    copy_wait<1>();
    __syncwarp();
    {
      const float tlx = sub(klx, static_cast<float>(r + 1));
      const float tly = sub(kly, static_cast<float>(r + 1));
      const int x0 = to_int(floorf(tlx)), y0 = to_int(floorf(tly));
      const float* b = blk + l * BP * BP;
      Walk rc(lane, P);
      for (int q = lane; q < P * P; q += 32, rc.next()) {
        const Hat hy = hat(add(tly, static_cast<float>(rc.i)));
        const Hat hx = hat(add(tlx, static_cast<float>(rc.j)));
        // the block's row and column of the taps (floor(tl + i) is
        // floor(tl) + i, or + 1 where the sum rounds up to an integer, and
        // then the second tap's weight is 0)
        const int ry = clampi(hy.i0 - y0, 0, P), rx = clampi(hx.i0 - x0, 0, P);
        const int ry1 = clampi(hy.i0 + 1 - y0, 0, P);
        const int rx1 = clampi(hx.i0 + 1 - x0, 0, P);
        const float r0 = add(mul(hy.w0, b[ry * BP + rx]),
                             mul(hy.w1, b[ry1 * BP + rx]));
        const float r1 = add(mul(hy.w0, b[ry * BP + rx1]),
                             mul(hy.w1, b[ry1 * BP + rx1]));
        tpl[q] = add(mul(r0, hx.w0), mul(r1, hx.w1));
      }
    }
    __syncwarp();

    float T[kPix], Ix[kPix], Iy[kPix];
    float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      T[k] = Ix[k] = Iy[k] = 0.f;
      if (lane + 32 * k < npx) {
        const int t = tidx[k];
        T[k] = tpl[t];
        Ix[k] = mul(0.5f, sub(tpl[t + 1], tpl[t - 1]));
        Iy[k] = mul(0.5f, sub(tpl[t + P], tpl[t - P]));
        sxx = add(sxx, mul(Ix[k], Ix[k]));
        sxy = add(sxy, mul(Ix[k], Iy[k]));
        syy = add(syy, mul(Iy[k], Iy[k]));
      }
    }
    const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
    const float det = sub(mul(gxx, gyy), mul(gxy, gxy));
    const float tr = add(gxx, gyy);
    const float disc = clamp_lo(sub(mul(tr, tr), mul(4.f, det)), 0.f);
    const float min_eig = __fdiv_rn(sub(tr, __fsqrt_rn(disc)),
                                    static_cast<float>(2 * npx));
    const bool good_g = min_eig > p.min_eig_th;
    const float det_safe = fabsf(det) < 1e-12f ? 1e-12f : det;
    const float iA = __fdiv_rn(gyy, det_safe);
    const float iB = __fdiv_rn(-gxy, det_safe);
    const float iD = __fdiv_rn(gxx, det_safe);

    copy_wait<0>();   // the search patch
    __syncwarp();
    if (alive && good_g) {
      for (int it = 0; it < p.iters; ++it) {
        const float ox = sub(sub(add(klx, fx), static_cast<float>(r)), bx);
        const float oy = sub(sub(add(kly, fy), static_cast<float>(r)), by);
        const Window w = window_at(ox, oy, shifts, SP);
        float ex = 0.f, ey = 0.f;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (lane + 32 * k < npx) {
            const float d = sub(T[k], window_px(sp, SP, w, pidx[k]));
            ex = add(ex, mul(Ix[k], d));
            ey = add(ey, mul(Iy[k], d));
          }
        }
        ex = warp_sum(ex);
        ey = warp_sum(ey);
        const float dx = add(mul(iA, ex), mul(iB, ey));
        const float dy = add(mul(iB, ex), mul(iD, ey));
        fx = add(fx, dx);
        fy = add(fy, dy);
        ++steps;
        if (add(mul(dx, dx), mul(dy, dy)) < p.eps2) break;
      }
    }

    const float cx = add(klx, fx), cy = add(kly, fy);
    const bool in_img = cx >= static_cast<float>(r) &&
                        cx <= static_cast<float>(WA - 1 - r) &&
                        cy >= static_cast<float>(r) &&
                        cy <= static_cast<float>(HA - 1 - r);
    const Window w = window_at(sub(sub(cx, static_cast<float>(r)), bx),
                               sub(sub(cy, static_cast<float>(r)), by),
                               shifts, SP);
    float e = 0.f;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (lane + 32 * k < npx)
        e = add(e, fabsf(sub(window_px(sp, SP, w, pidx[k]), T[k])));
    }
    residual = __fdiv_rn(warp_sum(e), static_cast<float>(npx));
    alive = alive && good_g && in_img;
    if (l > 0) {
      fx = mul(fx, 2.f);
      fy = mul(fy, 2.f);
    }
  }
  return residual;
}

template <int kPix>
__global__ void __launch_bounds__(kWarps * 32)
klt_kernel(const __grid_constant__ Levels lv, const Params p, const float* __restrict__ kps,
           const float* __restrict__ priors,
           const uint8_t* __restrict__ valid, float* __restrict__ out_xy,
           uint8_t* __restrict__ out_status, float* __restrict__ out_residual,
           int* __restrict__ out_steps) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= p.n) return;                 // warp-uniform
  float* sm = reinterpret_cast<float*>(smem4) + warp * p.lay.warp_floats;
  const float* kp = kps + static_cast<size_t>(n) * p.kps_stride;
  const float* pr = priors + static_cast<size_t>(n) * p.priors_stride;
  const float kx = kp[0], ky = kp[1];
  const float scale0 = static_cast<float>(1 << (p.levels - 1));
  float fx = __fdiv_rn(sub(pr[0], kx), scale0);
  float fy = __fdiv_rn(sub(pr[1], ky), scale0);
  bool alive = valid[n] != 0;
  int steps = 0;
  const float res = track<kPix>(lv, 0, p.levels, p, kx, ky, fx, fy, alive,
                                steps, sm);
  const bool st_f = alive && res < p.max_err;
  const float tx = add(kx, fx), ty = add(ky, fy);
  bool status = st_f;
  if (p.back_levels > 0) {
    const float sb = static_cast<float>(1 << (p.back_levels - 1));
    float bfx = __fdiv_rn(sub(kx, tx), sb);
    float bfy = __fdiv_rn(sub(ky, ty), sb);
    bool alive_b = st_f;
    const float res_b = track<kPix>(lv, 1, p.back_levels, p, tx, ty, bfx,
                                    bfy, alive_b, steps, sm);
    const float ddx = sub(add(tx, bfx), kx), ddy = sub(add(ty, bfy), ky);
    const float fb = __fsqrt_rn(add(mul(ddx, ddx), mul(ddy, ddy)));
    status = st_f && alive_b && res_b < p.max_err && fb <= p.max_fb;
  }
  if (lane == 0) {
    out_xy[2 * n] = tx;
    out_xy[2 * n + 1] = ty;
    out_status[n] = status ? 1 : 0;
    out_residual[n] = res;
    if (out_steps != nullptr) out_steps[n] = steps;
  }
}

int up4(int x) { return (x + 3) & ~3; }

Layout layout(int levels, int win, int margin) {
  const int BP = win + 3, SP = win + 2 * margin + 1, P = win + 2;
  Layout l;
  l.blk = 0;
  l.sp = l.blk + up4(levels * BP * BP);
  l.tpl = l.sp + up4(SP * SP);
  l.warp_floats = l.tpl + up4(P * P);
  return l;
}

template <int kPix>
int launch(const Levels& lv, const Params& p, int grid, cudaStream_t stream,
           const float* kps, const float* priors, const uint8_t* valid,
           float* out_xy, uint8_t* out_status, float* out_residual,
           int* out_steps) {
  const size_t bytes = sizeof(float) * kWarps * p.lay.warp_floats;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        klt_kernel<kPix>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  klt_kernel<kPix><<<grid, kWarps * 32, bytes, stream>>>(
      lv, p, kps, priors, valid, out_xy, out_status, out_residual,
      out_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on ``stream``; returns 0, a cudaError_t, or -1 for arguments the
// kernel is not sized for. Host arrays: ptrs (2 * levels device pointers,
// the prev levels then the cur levels) and dims (4 * levels ints: prev H,
// prev W, cur H, cur W per level). Device pointers: kps, priors (n, 2) f32
// with the two floats of a row adjacent and rows kps_stride, priors_stride
// floats apart (a view of a packed state is read in place), valid (n,)
// bytes; out_xy (n, 2) f32, out_status (n,) bytes, out_residual
// (n,) f32 (the forward pass's), out_steps (n,) int32 or null (LK steps
// taken over every pass). back_levels 0 is klt_track, > 0 fb_klt_track.
// Level images are f32, rows contiguous, 4-byte aligned.
extern "C" int klt_track_launch(const void* ptrs, const void* dims,
                                int levels, int back_levels,
                                const void* kps, const void* priors,
                                const void* valid, int n, int kps_stride,
                                int priors_stride, int win, int iters,
                                int margin, float eps2, float min_eig_th,
                                float max_err, float max_fb, void* out_xy,
                                void* out_status, void* out_residual,
                                void* out_steps, void* stream) {
  if (levels < 1 || levels > kMaxLevels || back_levels < 0 ||
      back_levels > levels || n < 1 || kps_stride < 0 ||
      priors_stride < 0 || win < 1 || win > kMaxWin ||
      margin < 0 || margin > kMaxMargin || iters < 0)
    return -1;
  const auto* pt = static_cast<const int64_t*>(ptrs);
  const auto* dm = static_cast<const int32_t*>(dims);
  Levels lv{};
  for (int l = 0; l < levels; ++l) {
    lv.img[0][l] = reinterpret_cast<const float*>(pt[l]);
    lv.img[1][l] = reinterpret_cast<const float*>(pt[levels + l]);
    lv.h[0][l] = dm[4 * l];
    lv.w[0][l] = dm[4 * l + 1];
    lv.h[1][l] = dm[4 * l + 2];
    lv.w[1][l] = dm[4 * l + 3];
  }
  const Params p{levels, back_levels, n, kps_stride, priors_stride, win,
                 iters, margin,
                 eps2, min_eig_th, max_err, max_fb,
                 layout(levels, win, margin)};
  const int grid = (n + kWarps - 1) / kWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const float*>(kps);
  const auto* pr = static_cast<const float*>(priors);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* xy = static_cast<float*>(out_xy);
  auto* st = static_cast<uint8_t*>(out_status);
  auto* res = static_cast<float*>(out_residual);
  auto* stp = static_cast<int*>(out_steps);
  // window pixels a lane holds: 3 up to win 9 (the configurations'), 8 up
  // to kMaxWin; the loops over them are unrolled, so a window that fits
  // takes the smaller instantiation
  return win * win <= 32 * 3
             ? launch<3>(lv, p, grid, s, k, pr, v, xy, st, res, stp)
             : launch<8>(lv, p, grid, s, k, pr, v, xy, st, res, stp);
}
