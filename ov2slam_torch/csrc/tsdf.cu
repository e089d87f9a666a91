// Dense fusion on the card: the projective TSDF update of a whole voxel grid
// in place, and one Jacobi sweep of the ESDF's chamfer transform.
//
// Replace the XLA-compiled form of ov2slam_tpu/mapping/tsdf.py's
// _tsdf_integrate (:33) and _esdf_sweep (:91), which the JAX package jits
// as one fused elementwise + gather pass and a lax.scan of 6-neighbour
// min-plus steps. No Pallas kernel stands behind them. The plain PyTorch
// versions are mapping/tsdf.py::_tsdf_integrate_plain and
// _esdf_sweep_plain; these kernels compute what they compute on the card,
// bit for bit, NaNs where they have them.
//
// Integration (tsdf_integrate_kernel), per voxel (i, j, k) of the grid in
// C order, z fastest:
//
//   p = (idx + 0.5) * voxel + origin              (per axis)
//   uv = q x p; uuv = q x uv; pc = p + 2 (qw uv + uuv) + t
//   zs = z > 1e-6 ? z : 1; u = fx x / zs + cx; v = fy y / zs + cy
//   pix = clamp(rint(v), 0, H-1) W + clamp(rint(u), 0, W-1)  (int32)
//   d = depth[pix]; sdf = d - z; obs = clamp(sdf * (1/trunc), -1, 1)
//   upd = in front, inside the image, d finite in [min_ray, max_ray],
//         sdf > -trunc
//   w_obs = upd ? (const ? 1 : (1 / (max(d, 1e-3))^2) * 1) : 0
//   w_new = w + w_obs; den = max(w_new, 1e-9)
//   tsdf = (tsdf w + obs w_obs) / den; color = (color w + rgb[pix] w_obs)
//          / den; w = min(w_new, max_weight)
//
// Every voxel is written, in or out of the frustum: the plain version
// rewrites them all, (t w) / max(w, 1e-9) is not always t in f32, and a
// NaN depth at a voxel's (clipped) pixel makes obs NaN and NaN * 0 poisons
// the voxel, in the JAX package as in the port.
//
// Rounding. Each eager operation of the plain version rounds once in IEEE
// f32, so every one is written as the intrinsic that rounds it
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: none can be contracted into
// an FMA) in the plain version's order, as ATen executes it on the card: a
// division by a tensor (x / zs, the tsdf's and colour's / den) is IEEE; the
// division by the Python number trunc is ATen's product with the f32
// reciprocal 1/trunc, formed once on the host (the launch's inv_trunc);
// `1.0 / t` is torch's reciprocal (an IEEE 1/t) times 1; `t ** 2` is t * t;
// torch.round is rint (half to even); the float-to-int32 conversion
// truncates as ATen's copy does (a NaN to 0); clamp, clamp(min=) and
// clamp(max=) keep a NaN. Never build this file with --use_fast_math.
//
// Bound on an H100 SXM. A voxel reads and writes its tsdf, weight and
// colour once, 40 bytes (16 without colour), and the depth and colour
// images are read once: slice G's call (640 x 640 x 64 voxels, 800 x 600
// pixels) moves 1056 MB, 0.315 ms at 3.35 TB/s. Its 92 f32 operations a
// voxel take 0.036 ms at 67 TFLOP/s (roofline.py::tsdf_integrate_bound):
// bytes bind. Design: four consecutive voxels a thread, whose tsdf and
// weight are one 16-byte load each and whose colour is three (when the
// state is 16-byte aligned; else one voxel at a time); neighbouring
// threads on neighbouring addresses. A thread projects its four voxels,
// then issues all their gathers of depth and colour (1.9 and 5.8 MB
// images, through L2), then updates them. Every loop over the four is
// unrolled with a compile-time bound, so the voxels stay in registers (a
// run-time bound put them on the stack: 0.642 device ms against 0.374,
// tsdf_probe.py). The pose, intrinsics and constants are kernel
// arguments, so the host never reads a device value. No shared memory,
// no atomics.
//
// The sweep (esdf_sweep4_kernel, esdf_sweep_kernel). One Jacobi step of
// the chamfer transform: each voxel's new value is the minimum of its own
// value and its six neighbours' start-of-sweep values plus voxel, in the
// plain version's order (x-1, x+1, y-1, y+1, z-1, z+1; torch.minimum: a
// NaN in the running minimum stays, else a NaN neighbour is taken), a
// neighbour outside the grid counting as pad + voxel (the plain version
// pads with 1e9, then adds). It reads `src` and writes `dst`, two buffers: an
// in-place (Gauss-Seidel) step would be another function. Bound: 8 bytes a
// voxel (read once, written once), 0.0626 ms at slice G's 26.2 M voxels;
// its 12 f32 operations a voxel take 0.0047 ms at 67 TFLOP/s
// (roofline.py::esdf_sweep_bound). Design: a CTA owns a tile of columns
// and walks a short run of x planes; each thread keeps its own column's
// x-1, x and x+1 values in registers, and each plane, with a one-voxel
// halo in y and z, is staged in shared memory with voxel already added
// (each value is added once a plane, as the plain version adds once to
// its padded grid). Where nz is a multiple of 4 and the buffers are
// 16-byte aligned (slice G's grid), esdf_sweep4_kernel takes four z-voxels
// a thread as one float4 (a 32 x 32 tile, runs of 2 planes); else
// esdf_sweep_kernel one voxel a thread (a 32 x 8 tile, runs of 16). Why
// these (tsdf_probe.py at slice G's size, device ms a sweep): the float4
// walk takes 0.1156, 0.1068, 0.0963, 0.0930 and 0.1125 at runs of 16, 8,
// 4, 2 and 1 planes (more, shorter CTAs fill the card's waves better,
// until a run no longer reuses its planes), the scalar walk 0.1394 at 16;
// loading a plane ahead into two buffers (0.162-0.174) and one thread a
// voxel reading its neighbours through the caches (0.146) were slower.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVoxelsPerThread = 4;
constexpr int kTileZ = 32;
constexpr int kTileY = 8;
constexpr int kRunX = 16;        // the scalar sweep's run of x planes
constexpr int kQuadsZ = 8;       // the 4-voxel sweep's tile: 8 float4 in z
constexpr int kRowsY = 32;       // ... by 32 rows in y
constexpr int kQuadRunX = 2;     // ... and its run of x planes

struct IntegrateParams {
  float* tsdf;
  float* weight;
  float* color;          // nullptr: no colour update
  const float* depth;
  const float* rgb;      // with color
  int nx, ny, nz, H, W;
  int vec;               // the state is 16-byte aligned
  float qw, qx, qy, qz, tx, ty, tz;
  float fx, fy, cx, cy;
  float ox, oy, oz, voxel;
  float z_min, inv_trunc, neg_trunc, min_ray, max_ray, min_depth,
      min_denom, max_weight;
  int const_weight;
};

// torch.clamp(v, lo, hi), clamp(min=) and clamp(max=) on the card: a NaN
// stays
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max_nan(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// a voxel centre's coordinate on one axis: (idx + 0.5) * voxel + o
__device__ __forceinline__ float centre(int idx, float voxel, float o) {
  return __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(idx), 0.5f),
                             voxel), o);
}

// a - b and a * b - c * d, each product and the difference rounded
__device__ __forceinline__ float cross(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// Where a voxel centre projects: its camera-frame depth z, the flat
// index of its (clipped) pixel, and whether it lies in front of the
// camera and inside the image.
struct Projection {
  float z;
  int pix;
  bool in_img;
};

__device__ __forceinline__ Projection project(const IntegrateParams& p,
                                              int i, int j, int k) {
  const float p0 = centre(i, p.voxel, p.ox);
  const float p1 = centre(j, p.voxel, p.oy);
  const float p2 = centre(k, p.voxel, p.oz);
  // uv = qv x p, uuv = qv x uv, pc = p + 2 (qw uv + uuv) + t
  const float uv0 = cross(p.qy, p2, p.qz, p1);
  const float uv1 = cross(p.qz, p0, p.qx, p2);
  const float uv2 = cross(p.qx, p1, p.qy, p0);
  const float uuv0 = cross(p.qy, uv2, p.qz, uv1);
  const float uuv1 = cross(p.qz, uv0, p.qx, uv2);
  const float uuv2 = cross(p.qx, uv1, p.qy, uv0);
  const float x = __fadd_rn(__fadd_rn(p0, __fmul_rn(2.0f, __fadd_rn(
      __fmul_rn(p.qw, uv0), uuv0))), p.tx);
  const float y = __fadd_rn(__fadd_rn(p1, __fmul_rn(2.0f, __fadd_rn(
      __fmul_rn(p.qw, uv1), uuv1))), p.ty);
  const float z = __fadd_rn(__fadd_rn(p2, __fmul_rn(2.0f, __fadd_rn(
      __fmul_rn(p.qw, uv2), uuv2))), p.tz);

  const bool front = z > p.z_min;
  const float zs = front ? z : 1.0f;
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(p.fx, x), zs), p.cx);
  const float v = __fadd_rn(__fdiv_rn(__fmul_rn(p.fy, y), zs), p.cy);
  const float W1 = static_cast<float>(p.W - 1);
  const float H1 = static_cast<float>(p.H - 1);
  const int ui = __float2int_rz(clamp_nan(rintf(u), 0.0f, W1));
  const int vi = __float2int_rz(clamp_nan(rintf(v), 0.0f, H1));
  Projection r;
  r.z = z;
  r.pix = vi * p.W + ui;
  r.in_img = front && u >= 0.0f && u <= W1 && v >= 0.0f && v <= H1;
  return r;
}

// One voxel's update of its tsdf t, weight w and colour c[0..2] (when
// p.color, from the gathered rgb[0..2]) by the depth d at its pixel.
__device__ __forceinline__ void update_voxel(const IntegrateParams& p,
                                             const Projection& pr, float d,
                                             const float* rgb, float& t,
                                             float& w, float* c) {
  const bool d_ok = isfinite(d) && d >= p.min_ray && d <= p.max_ray;
  const float sdf = __fsub_rn(d, pr.z);
  const bool upd = pr.in_img && d_ok && sdf > p.neg_trunc;
  const float obs = clamp_nan(__fmul_rn(sdf, p.inv_trunc), -1.0f, 1.0f);
  float w_obs = 1.0f;
  if (!p.const_weight) {
    const float dc = clamp_min_nan(d, p.min_depth);
    w_obs = __fmul_rn(__fdiv_rn(1.0f, __fmul_rn(dc, dc)), 1.0f);
  }
  w_obs = upd ? w_obs : 0.0f;

  const float w_new = __fadd_rn(w, w_obs);
  const float den = clamp_min_nan(w_new, p.min_denom);
  t = __fdiv_rn(__fadd_rn(__fmul_rn(t, w), __fmul_rn(obs, w_obs)), den);
  if (p.color != nullptr) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      c[ch] = __fdiv_rn(__fadd_rn(__fmul_rn(c[ch], w),
                                  __fmul_rn(rgb[ch], w_obs)), den);
  }
  w = clamp_max_nan(w_new, p.max_weight);
}

__global__ void __launch_bounds__(kThreads)
    tsdf_integrate_kernel(IntegrateParams p) {
  constexpr int kN = kVoxelsPerThread;
  const int64_t V = static_cast<int64_t>(p.nx) * p.ny * p.nz;
  const int64_t v0 = kN *
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (v0 >= V) return;
  const int n = static_cast<int>(V - v0 < kN ? V - v0 : kN);
  const bool color = p.color != nullptr;
  const bool vec = p.vec && n == kN;

  // every loop below is unrolled, so that these stay in registers
  float t[kN] = {}, w[kN] = {}, c[3 * kN] = {};
  if (vec) {
    const float4 tv = *reinterpret_cast<const float4*>(p.tsdf + v0);
    const float4 wv = *reinterpret_cast<const float4*>(p.weight + v0);
    t[0] = tv.x; t[1] = tv.y; t[2] = tv.z; t[3] = tv.w;
    w[0] = wv.x; w[1] = wv.y; w[2] = wv.z; w[3] = wv.w;
    if (color) {
      const float4* cp = reinterpret_cast<const float4*>(p.color + 3 * v0);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 cv = cp[q];
        c[4 * q] = cv.x; c[4 * q + 1] = cv.y;
        c[4 * q + 2] = cv.z; c[4 * q + 3] = cv.w;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      if (q < n) {
        t[q] = p.tsdf[v0 + q];
        w[q] = p.weight[v0 + q];
        if (color) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            c[3 * q + ch] = p.color[3 * (v0 + q) + ch];
        }
      }
    }
  }

  // the voxels' projections ((i, j, k) of the first; the next ones step
  // along z), then all their gathers, then the updates
  const int64_t plane = static_cast<int64_t>(p.ny) * p.nz;
  int i = static_cast<int>(v0 / plane);
  const int rem = static_cast<int>(v0 - i * plane);
  int j = rem / p.nz;
  int k = rem - j * p.nz;
  Projection pr[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    pr[q] = project(p, i, j, k);
    if (++k == p.nz) {
      k = 0;
      if (++j == p.ny) { j = 0; ++i; }
    }
  }
  float d[kN], rgb[3 * kN];
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    d[q] = __ldg(p.depth + pr[q].pix);
    if (color) {
      const float* src = p.rgb + 3 * static_cast<size_t>(pr[q].pix);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) rgb[3 * q + ch] = __ldg(src + ch);
    }
  }
#pragma unroll
  for (int q = 0; q < kN; ++q)
    update_voxel(p, pr[q], d[q], rgb + 3 * q, t[q], w[q], c + 3 * q);

  if (vec) {
    *reinterpret_cast<float4*>(p.tsdf + v0) =
        make_float4(t[0], t[1], t[2], t[3]);
    *reinterpret_cast<float4*>(p.weight + v0) =
        make_float4(w[0], w[1], w[2], w[3]);
    if (color) {
      float4* cp = reinterpret_cast<float4*>(p.color + 3 * v0);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        cp[q] = make_float4(c[4 * q], c[4 * q + 1], c[4 * q + 2],
                            c[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      if (q < n) {
        p.tsdf[v0 + q] = t[q];
        p.weight[v0 + q] = w[q];
        if (color) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            p.color[3 * (v0 + q) + ch] = c[3 * q + ch];
        }
      }
    }
  }
}

struct SweepParams {
  const float* src;
  float* dst;
  int nx, ny, nz;
  float voxel;
  float pad;             // the plain version's padding value (1e9)
};

// torch.minimum on the card: a NaN in a stays, else a NaN in b is taken
__device__ __forceinline__ float minimum(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fminf(a, b);
}

__global__ void __launch_bounds__(kTileZ * kTileY)
    esdf_sweep_kernel(SweepParams p) {
  // plane x of the tile, voxel added, with a one-voxel halo in y and z
  __shared__ float tile[kTileY + 2][kTileZ + 2];
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int k = blockIdx.x * kTileZ + tz;
  const int j = blockIdx.y * kTileY + ty;
  const int i0 = blockIdx.z * kRunX;
  const int i1 = min(i0 + kRunX, p.nx);
  const bool kin = k < p.nz;
  const bool in = kin && j < p.ny;
  const int plane = p.ny * p.nz;
  const float* col = p.src + j * p.nz + k;   // this thread's column
  // the y halo rows and z halo columns this thread stages, if any
  const int jh = ty == 0 ? j - 1 : (ty == kTileY - 1 ? j + 1 : -1);
  const int yh = ty == 0 ? 0 : kTileY + 1;
  const bool y_halo = (ty == 0 || ty == kTileY - 1) && kin && jh >= 0 &&
                      jh < p.ny;
  const int kh = tz == 0 ? k - 1 : (tz == kTileZ - 1 ? k + 1 : -1);
  const int zh = tz == 0 ? 0 : kTileZ + 1;
  const bool z_halo = (tz == 0 || tz == kTileZ - 1) && j < p.ny &&
                      kh >= 0 && kh < p.nz;
  const float far = __fadd_rn(p.pad, p.voxel);   // outside the grid

  float prev = 0.0f, cur = 0.0f;
  if (in) {
    cur = col[static_cast<size_t>(i0) * plane];
    if (i0 > 0) prev = col[static_cast<size_t>(i0 - 1) * plane];
  }
  for (int i = i0; i < i1; ++i) {
    const size_t off = static_cast<size_t>(i) * plane;
    const float next = in && i + 1 < p.nx ? col[off + plane] : 0.0f;
    tile[ty + 1][tz + 1] = in ? __fadd_rn(cur, p.voxel) : far;
    if (ty == 0 || ty == kTileY - 1)
      tile[yh][tz + 1] = y_halo
          ? __fadd_rn(p.src[off + jh * p.nz + k], p.voxel) : far;
    if (tz == 0 || tz == kTileZ - 1)
      tile[ty + 1][zh] = z_halo
          ? __fadd_rn(p.src[off + j * p.nz + kh], p.voxel) : far;
    __syncthreads();
    if (in) {
      float r = cur;
      r = minimum(r, i > 0 ? __fadd_rn(prev, p.voxel) : far);
      r = minimum(r, i + 1 < p.nx ? __fadd_rn(next, p.voxel) : far);
      r = minimum(r, tile[ty][tz + 1]);
      r = minimum(r, tile[ty + 2][tz + 1]);
      r = minimum(r, tile[ty + 1][tz]);
      r = minimum(r, tile[ty + 1][tz + 2]);
      p.dst[off + j * p.nz + k] = r;
    }
    __syncthreads();
    prev = cur;
    cur = next;
  }
}

// The sweep four z-voxels a thread (nz a multiple of 4, 16-byte aligned
// buffers): a CTA owns a 32 (z) x 32 (y) tile, 8 x 32 threads, and a run
// of kQuadRunX planes; each thread's column is a float4.
__global__ void __launch_bounds__(kQuadsZ * kRowsY)
    esdf_sweep4_kernel(SweepParams p) {
  __shared__ float tile[kRowsY + 2][4 * kQuadsZ + 2];
  const int tq = threadIdx.x, ty = threadIdx.y;
  const int k0 = (blockIdx.x * kQuadsZ + tq) * 4;
  const int j = blockIdx.y * kRowsY + ty;
  const int i0 = blockIdx.z * kQuadRunX;
  const int i1 = min(i0 + kQuadRunX, p.nx);
  const bool kin = k0 < p.nz;
  const bool in = kin && j < p.ny;
  const int plane = p.ny * p.nz;
  const float far = __fadd_rn(p.pad, p.voxel);
  const int col = j * p.nz + k0;
  const int jh = ty == 0 ? j - 1 : j + 1;
  const int yh = ty == 0 ? 0 : kRowsY + 1;
  const bool y_halo = (ty == 0 || ty == kRowsY - 1) && kin && jh >= 0 &&
                      jh < p.ny;
  const int kh = tq == 0 ? k0 - 1 : k0 + 4;
  const int zh = tq == 0 ? 0 : 4 * kQuadsZ + 1;
  const bool z_halo = (tq == 0 || tq == kQuadsZ - 1) && j < p.ny &&
                      kh >= 0 && kh < p.nz;
  auto ld4 = [&](size_t off) {
    return *reinterpret_cast<const float4*>(p.src + off);
  };
  float4 prev = make_float4(0.f, 0.f, 0.f, 0.f), cur = prev;
  if (in) {
    cur = ld4(static_cast<size_t>(i0) * plane + col);
    if (i0 > 0) prev = ld4(static_cast<size_t>(i0 - 1) * plane + col);
  }
  for (int i = i0; i < i1; ++i) {
    const size_t off = static_cast<size_t>(i) * plane;
    float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in && i + 1 < p.nx) next = ld4(off + plane + col);
    const float c[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tile[ty + 1][4 * tq + q + 1] = in ? __fadd_rn(c[q], p.voxel) : far;
    if (ty == 0 || ty == kRowsY - 1) {
      float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
      if (y_halo) h = ld4(off + jh * p.nz + k0);
      const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tile[yh][4 * tq + q + 1] = y_halo ? __fadd_rn(hv[q], p.voxel) : far;
    }
    if (tq == 0 || tq == kQuadsZ - 1)
      tile[ty + 1][zh] = z_halo
          ? __fadd_rn(p.src[off + j * p.nz + kh], p.voxel) : far;
    __syncthreads();
    if (in) {
      const float pv[4] = {prev.x, prev.y, prev.z, prev.w};
      const float nv[4] = {next.x, next.y, next.z, next.w};
      float r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int z = 4 * tq + q + 1;
        float v = c[q];
        v = minimum(v, i > 0 ? __fadd_rn(pv[q], p.voxel) : far);
        v = minimum(v, i + 1 < p.nx ? __fadd_rn(nv[q], p.voxel) : far);
        v = minimum(v, tile[ty][z]);
        v = minimum(v, tile[ty + 2][z]);
        v = minimum(v, tile[ty + 1][z - 1]);
        v = minimum(v, tile[ty + 1][z + 1]);
        r[q] = v;
      }
      *reinterpret_cast<float4*>(p.dst + off + col) =
          make_float4(r[0], r[1], r[2], r[3]);
    }
    __syncthreads();
    prev = cur;
    cur = next;
  }
}

}  // namespace

// Launches one projective TSDF update of the grid (nx, ny, nz) in place on
// `stream`; returns the CUDA error code (0: none; -1: arguments the kernel
// does not take). tsdf and weight hold V = nx ny nz floats, color V x 3
// (or nullptr, with rgb: no colour update); depth H x W floats, rgb
// H x W x 3. The constants are the plain version's f32 values
// (mapping/tsdf.py::pack_integrate).
extern "C" int tsdf_integrate_launch(
    void* tsdf, void* weight, void* color, const void* depth,
    const void* rgb, int nx, int ny, int nz, int H, int W, float qw,
    float qx, float qy, float qz, float tx, float ty, float tz, float fx,
    float fy, float cx, float cy, float ox, float oy, float oz, float voxel,
    float z_min, float inv_trunc, float neg_trunc, float min_ray,
    float max_ray, float min_depth, float min_denom, float max_weight,
    int const_weight, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || H < 1 || W < 1 || tsdf == nullptr ||
      weight == nullptr || depth == nullptr ||
      (color == nullptr) != (rgb == nullptr))
    return -1;
  const int64_t V = static_cast<int64_t>(nx) * ny * nz;
  if (V >= (int64_t{1} << 31) || static_cast<int64_t>(H) * W >=
      (int64_t{1} << 31))
    return -1;
  IntegrateParams p{};
  p.tsdf = static_cast<float*>(tsdf);
  p.weight = static_cast<float*>(weight);
  p.color = static_cast<float*>(color);
  p.depth = static_cast<const float*>(depth);
  p.rgb = static_cast<const float*>(rgb);
  p.nx = nx; p.ny = ny; p.nz = nz; p.H = H; p.W = W;
  p.vec = ((reinterpret_cast<uintptr_t>(tsdf) |
            reinterpret_cast<uintptr_t>(weight) |
            reinterpret_cast<uintptr_t>(color)) & 15) == 0;
  p.qw = qw; p.qx = qx; p.qy = qy; p.qz = qz;
  p.tx = tx; p.ty = ty; p.tz = tz;
  p.fx = fx; p.fy = fy; p.cx = cx; p.cy = cy;
  p.ox = ox; p.oy = oy; p.oz = oz; p.voxel = voxel;
  p.z_min = z_min; p.inv_trunc = inv_trunc; p.neg_trunc = neg_trunc;
  p.min_ray = min_ray; p.max_ray = max_ray; p.min_depth = min_depth;
  p.min_denom = min_denom; p.max_weight = max_weight;
  p.const_weight = const_weight;
  const int64_t threads = (V + kVoxelsPerThread - 1) / kVoxelsPerThread;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) /
                                                kThreads);
  tsdf_integrate_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launches one sweep from `src` into `dst` (two buffers of nx ny nz floats)
// on `stream`; a neighbour outside the grid counts as pad + voxel. Returns
// the CUDA error code (0: none; -1: arguments the kernel does not take).
extern "C" int esdf_sweep_launch(const void* src, void* dst, int nx, int ny,
                                 int nz, float voxel, float pad,
                                 void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || src == nullptr || dst == nullptr ||
      src == dst)
    return -1;
  if (static_cast<int64_t>(nx) * ny * nz >= (int64_t{1} << 31)) return -1;
  SweepParams p{};
  p.src = static_cast<const float*>(src);
  p.dst = static_cast<float*>(dst);
  p.nx = nx; p.ny = ny; p.nz = nz;
  p.voxel = voxel;
  p.pad = pad;
  if (nz % 4 == 0 && ((reinterpret_cast<uintptr_t>(src) |
                        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const dim3 block(kQuadsZ, kRowsY);
    const dim3 grid((nz / 4 + kQuadsZ - 1) / kQuadsZ,
                    (ny + kRowsY - 1) / kRowsY,
                    (nx + kQuadRunX - 1) / kQuadRunX);
    esdf_sweep4_kernel<<<grid, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  } else {
    const dim3 block(kTileZ, kTileY);
    const dim3 grid((nz + kTileZ - 1) / kTileZ, (ny + kTileY - 1) / kTileY,
                    (nx + kRunX - 1) / kRunX);
    esdf_sweep_kernel<<<grid, block, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
