// Fixed-point undistortion of pixels, and distortion alone, one thread a
// point.
//
// Replaces the XLA-compiled form of ov2slam_tpu/core/camera.py's
// distort_radtan (:37), distort_fisheye (:48) and _undistort_iterative
// (:60), and of ov2slam_tpu/models/frontend_step.py::_undistort_px (:53),
// which the JAX package fuses into its jitted tracking, detection and
// mapping steps. No Pallas kernel stands behind them. The plain PyTorch
// versions are core/camera.py::undistort_points_plain and
// distort_points_plain; this kernel computes what they compute:
//
//   mode 0 (undistort): xn = (px - c) / f; xu = xn, then `iters` times
//     xu = xn - (distort(xu) - xu); out = xu * f + c;
//   mode 1 (distort pixels): out = distort((px - c) / f) * f + c;
//   mode 2 (distort normalised coordinates): out = distort(x) * f + c;
//   distort is radtan [k1 k2 p1 p2] or Kannala-Brandt [k1 k2 k3 k4].
//
// Rounding. Each PyTorch operation of the plain version rounds once in
// IEEE f32, so every one is written here as the intrinsic that rounds it
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: none can be
// contracted into an FMA), in the plain version's order: the division by
// f is an IEEE division (f is a device tensor there, not a Python number);
// `2 * p1 * x * y` is ((2 p1) x) y; `t2 ** 2` and `t2 ** 3` are the
// products torch's pow takes for those exponents and `t2 ** 4` its powf;
// the clamp of r^2 at 1e-18 keeps a NaN as torch's clamp does. So every
// output is the plain version's on the card bit for bit. Never build this
// file with --use_fast_math.
//
// Bound on an H100 SXM. A point reads 8 bytes and writes 8, and does 28
// FLOP a radtan distortion: the front end's call (512 points, 8
// iterations) moves 8 KB, 0.0000025 ms at 3.35 TB/s, and does 0.14 MFLOP,
// 0.000002 ms at 67 TFLOP/s (roofline.py::undistort_points_bound). Neither
// binds: a point's iterations are a dependent chain of ~8 x 12 rounded
// operations, and the call is one launch's latency.
//
// Design. One thread a point, 128 threads a CTA; the calibration (fx, fy,
// cx, cy and the four coefficients) is read through device pointers, so
// the caller's 0-d tensors are never read on the host and the launch can
// be captured in a CUDA graph. All work in registers; no shared memory,
// no atomics.
//
// The tracks' tail (undistort_normalize_launch). The front end's every
// frame and stereo mapping's every keyframe ran this kernel between a few
// eager elementwise kernels on the same rows: the selection of the
// tracked pixels, the normalisation of the undistorted ones and of the
// reference keyframe's, and the pair mask (ov2slam_tpu/models/
// frontend_step.py:264, :269, :275, :278-279; mapper_step.py:124-128).
// Each of those cost a launch and a host call for a few KB. The second
// kernel does them all in one launch, one thread a row:
//
//   t = status[i] ? fwd[i] : px[i]   (the select; written as `tracked`)
//   und = undistort(t)               (mode 0 above, the same device code)
//   xr = (und - c) / f               (__fsub_rn, then IEEE __fdiv_rn)
//   xl = (ref[i] - c_ref) / f_ref    (optional, a calibration of its own)
//   pair = status[i] & ref_valid[i]  (optional)
//
// each output bit-equal to the eager operation it replaces
// (core/camera.py::undistort_normalize_plain). The row and calibration
// loads are all issued before the first dependent operation, so a launch
// pays one memory round trip. Bound: the tracking step's call (512
// rows, every option) reads and writes 59 bytes a row, 30 KB, 0.000009 ms
// at 3.35 TB/s, and does 272 FLOP a row, 0.000002 ms at 67 TFLOP/s
// (roofline.py::undistort_normalize_bound); like the first kernel, it is
// one launch's latency and the 8 steps' dependent chain.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Params {
  const float* in;
  int n;
  int in_stride;          // floats between rows of the input
  const float* fx;
  const float* fy;
  const float* cx;
  const float* cy;
  const float* dist;      // 4 coefficients
  int mode;               // 0 undistort, 1 distort pixels, 2 distort xn
  int fisheye;
  int iters;
  float* out;             // (n, 2)
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// core/camera.py::distort_radtan
__device__ __forceinline__ void radtan(float x, float y, const float k[4],
                                       float& xd, float& yd) {
  const float r2 = add(mul(x, x), mul(y, y));
  const float radial = add(add(1.0f, mul(k[0], r2)), mul(mul(k[1], r2), r2));
  const float p1x2 = mul(2.0f, k[2]);
  const float p2x2 = mul(2.0f, k[3]);
  xd = add(add(mul(x, radial), mul(mul(p1x2, x), y)),
           mul(k[3], add(r2, mul(mul(2.0f, x), x))));
  yd = add(add(mul(y, radial), mul(k[2], add(r2, mul(mul(2.0f, y), y)))),
           mul(mul(p2x2, x), y));
}

// core/camera.py::distort_fisheye
__device__ __forceinline__ void fisheye(float x, float y, const float k[4],
                                        float& xd, float& yd) {
  float s = add(mul(x, x), mul(y, y));
  s = isnan(s) ? s : fmaxf(s, static_cast<float>(1e-18));
  const float r = __fsqrt_rn(s);
  const float theta = atanf(r);
  const float t2 = mul(theta, theta);
  const float t4 = mul(t2, t2);
  const float t6 = mul(mul(t2, t2), t2);
  const float t8 = powf(t2, 4.0f);
  float poly = add(1.0f, mul(k[0], t2));
  poly = add(poly, mul(k[1], t4));
  poly = add(poly, mul(k[2], t6));
  poly = add(poly, mul(k[3], t8));
  const float scale = __fdiv_rn(mul(theta, poly), r);
  xd = mul(x, scale);
  yd = mul(y, scale);
}

__device__ __forceinline__ void distort(bool fe, float x, float y,
                                        const float k[4], float& xd,
                                        float& yd) {
  if (fe) {
    fisheye(x, y, k, xd, yd);
  } else {
    radtan(x, y, k, xd, yd);
  }
}

// mode 0's fixed-point steps from the normalised point (x, y)
__device__ __forceinline__ void undistort_xn(bool fe, float x, float y,
                                             const float k[4], int iters,
                                             float& ox, float& oy) {
  ox = x;
  oy = y;
  for (int it = 0; it < iters; ++it) {
    float xd, yd;
    distort(fe, ox, oy, k, xd, yd);
    ox = sub(x, sub(xd, ox));
    oy = sub(y, sub(yd, oy));
  }
}

__global__ void __launch_bounds__(kThreads)
undistort_points_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const float fx = *p.fx, fy = *p.fy, cx = *p.cx, cy = *p.cy;
  const float k[4] = {p.dist[0], p.dist[1], p.dist[2], p.dist[3]};
  const bool fe = p.fisheye != 0;
  const float* row = p.in + static_cast<int64_t>(i) * p.in_stride;
  float x = row[0], y = row[1];
  if (p.mode != 2) {
    x = __fdiv_rn(sub(x, cx), fx);
    y = __fdiv_rn(sub(y, cy), fy);
  }
  float ox, oy;
  if (p.mode == 0) {
    undistort_xn(fe, x, y, k, p.iters, ox, oy);
  } else {
    distort(fe, x, y, k, ox, oy);
  }
  p.out[2 * i] = add(mul(ox, fx), cx);
  p.out[2 * i + 1] = add(mul(oy, fy), cy);
}

struct TailParams {
  const float* rows;             // fwd: the tracks' new pixels
  const float* px;               // the old pixels (select), or null
  const unsigned char* status;   // (n,) bool, with px
  const float* ref;              // reference rows, or null
  const unsigned char* ref_valid;  // (n,) bool: the pair mask, or null
  int n;
  int rows_stride, px_stride, ref_stride;   // floats between rows
  const float* fx;
  const float* fy;
  const float* cx;
  const float* cy;
  const float* dist;             // 4 coefficients
  const float* rfx;              // the reference rows' intrinsics
  const float* rfy;
  const float* rcx;
  const float* rcy;
  int fisheye;
  int iters;
  float* tracked;                // (n, 2), with px
  float* und;                    // (n, 2)
  float* xr;                     // (n, 2)
  float* xl;                     // (n, 2), with ref
  unsigned char* pair;           // (n,), with ref_valid
};

__global__ void __launch_bounds__(kThreads)
undistort_normalize_kernel(const TailParams p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float fx = *p.fx, fy = *p.fy, cx = *p.cx, cy = *p.cy;
  const float k[4] = {p.dist[0], p.dist[1], p.dist[2], p.dist[3]};
  float rfx = 0.f, rfy = 0.f, rcx = 0.f, rcy = 0.f;
  if (p.ref != nullptr) {
    rfx = *p.rfx;
    rfy = *p.rfy;
    rcx = *p.rcx;
    rcy = *p.rcy;
  }
  if (i >= p.n) return;
  // every row load before the first operation that needs one
  const float* r = p.rows + static_cast<int64_t>(i) * p.rows_stride;
  float tx = r[0], ty = r[1];
  float ox = 0.f, oy = 0.f, lx = 0.f, ly = 0.f;
  bool s = false, v = false;
  if (p.px != nullptr) {
    const float* q = p.px + static_cast<int64_t>(i) * p.px_stride;
    ox = q[0];
    oy = q[1];
    s = p.status[i] != 0;
  }
  if (p.ref != nullptr) {
    const float* q = p.ref + static_cast<int64_t>(i) * p.ref_stride;
    lx = q[0];
    ly = q[1];
  }
  if (p.ref_valid != nullptr) v = p.ref_valid[i] != 0;

  if (p.px != nullptr) {
    if (!s) {
      tx = ox;
      ty = oy;
    }
    p.tracked[2 * i] = tx;
    p.tracked[2 * i + 1] = ty;
  }
  float ux, uy;
  undistort_xn(p.fisheye != 0, __fdiv_rn(sub(tx, cx), fx),
               __fdiv_rn(sub(ty, cy), fy), k, p.iters, ux, uy);
  ux = add(mul(ux, fx), cx);
  uy = add(mul(uy, fy), cy);
  p.und[2 * i] = ux;
  p.und[2 * i + 1] = uy;
  p.xr[2 * i] = __fdiv_rn(sub(ux, cx), fx);
  p.xr[2 * i + 1] = __fdiv_rn(sub(uy, cy), fy);
  if (p.ref != nullptr) {
    p.xl[2 * i] = __fdiv_rn(sub(lx, rcx), rfx);
    p.xl[2 * i + 1] = __fdiv_rn(sub(ly, rcy), rfy);
  }
  if (p.ref_valid != nullptr) p.pair[i] = (s && v) ? 1 : 0;
}

}  // namespace

// Launches the kernel on `stream`; returns the CUDA error code (0: none).
// `in` holds n rows of 2 floats, `in_stride` floats apart; fx, fy, cx, cy
// point to one float each and dist to four, all on the device.
extern "C" int undistort_points_launch(const void* in, int n, int in_stride,
                                       const void* fx, const void* fy,
                                       const void* cx, const void* cy,
                                       const void* dist, int mode,
                                       int fisheye, int iters, void* out,
                                       void* stream) {
  if (n < 1 || in_stride < 2 || mode < 0 || mode > 2 || iters < 0)
    return -1;
  Params p{};
  p.in = static_cast<const float*>(in);
  p.n = n;
  p.in_stride = in_stride;
  p.fx = static_cast<const float*>(fx);
  p.fy = static_cast<const float*>(fy);
  p.cx = static_cast<const float*>(cx);
  p.cy = static_cast<const float*>(cy);
  p.dist = static_cast<const float*>(dist);
  p.mode = mode;
  p.fisheye = fisheye;
  p.iters = iters;
  p.out = static_cast<float*>(out);
  const int blocks = (n + kThreads - 1) / kThreads;
  undistort_points_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launches the tracks' tail on `stream`; returns the CUDA error code (0:
// none). `rows` holds n rows of 2 floats, `rows_stride` floats apart, as
// do `px` and `ref` with their strides; `px` (with `status`, n bools)
// selects, `ref` (under rfx, rfy, rcx, rcy) adds xl, `ref_valid` (n bools,
// with `status`) adds the pair mask; each null pointer leaves its part
// out. The calibration points to one float each and dist to four, all on
// the device.
extern "C" int undistort_normalize_launch(
    const void* rows, int rows_stride, const void* px, int px_stride,
    const void* status, const void* ref, int ref_stride,
    const void* ref_valid, int n, const void* fx, const void* fy,
    const void* cx, const void* cy, const void* dist, const void* rfx,
    const void* rfy, const void* rcx, const void* rcy, int fisheye,
    int iters, void* tracked, void* und, void* xr, void* xl,
    void* pair, void* stream) {
  if (n < 1 || rows_stride < 2 || iters < 0 || und == nullptr ||
      xr == nullptr)
    return -1;
  if (px != nullptr && (px_stride < 2 || status == nullptr ||
                        tracked == nullptr))
    return -1;
  if (ref != nullptr && (ref_stride < 2 || xl == nullptr || rfx == nullptr ||
                         rfy == nullptr || rcx == nullptr || rcy == nullptr))
    return -1;
  if (ref_valid != nullptr && (status == nullptr || pair == nullptr))
    return -1;
  TailParams p{};
  p.rows = static_cast<const float*>(rows);
  p.px = static_cast<const float*>(px);
  p.status = static_cast<const unsigned char*>(status);
  p.ref = static_cast<const float*>(ref);
  p.ref_valid = static_cast<const unsigned char*>(ref_valid);
  p.n = n;
  p.rows_stride = rows_stride;
  p.px_stride = px_stride;
  p.ref_stride = ref_stride;
  p.fx = static_cast<const float*>(fx);
  p.fy = static_cast<const float*>(fy);
  p.cx = static_cast<const float*>(cx);
  p.cy = static_cast<const float*>(cy);
  p.dist = static_cast<const float*>(dist);
  p.rfx = static_cast<const float*>(rfx);
  p.rfy = static_cast<const float*>(rfy);
  p.rcx = static_cast<const float*>(rcx);
  p.rcy = static_cast<const float*>(rcy);
  p.fisheye = fisheye;
  p.iters = iters;
  p.tracked = static_cast<float*>(tracked);
  p.und = static_cast<float*>(und);
  p.xr = static_cast<float*>(xr);
  p.xl = static_cast<float*>(xl);
  p.pair = static_cast<unsigned char*>(pair);
  const int blocks = (n + kThreads - 1) / kThreads;
  undistort_normalize_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
