// Separable FIR filter over an edge-replicated image, with optional 2x
// decimation: one launch a filtered (or decimated) image.
//
// Replaces the XLA-compiled form of ov2slam_tpu/core/image.py's _filter_x
// (:24) and _filter_y (:36), the shift-add FIRs that separable_filter
// (:47), gaussian_blur (:57), box_filter (:63), scharr_gradients (:68) and
// pyr_down (:78) chain, which the JAX package fuses into its jitted steps.
// No Pallas kernel stands behind them. The plain PyTorch version is
// core/image.py::separable_filter_plain; this kernel computes what it
// computes:
//
//   mid = the first pass (along y, or along x where `x_first` is set, as
//   scharr_gradients' gy is) of the image, out = the second pass of mid
//   along the other axis, each pass out = sum over the non-zero taps t_i,
//   in tap order, of t_i * p[i - r] (p the input of the pass, its edge
//   replicated, r = len(taps) // 2); at stride 2, out[::2, ::2].
//
// Rounding. The plain version starts each pass's sum from zeros_like and
// adds one rounded product per non-zero tap, each its own torch operation;
// here each product is __fmul_rn and each sum __fadd_rn in the same tap
// order, from +0 (so a first product of -0 gives +0 there too), and the
// first pass's result is kept in f32. So every output is the plain
// version's on the card bit for bit. Never build this file with
// --use_fast_math.
//
// Bound on an H100 SXM. The image is read once and the output written
// once: a pyramid level of 752x480 moves 1.44 MB + 0.36 MB, 0.00054 ms at
// 3.35 TB/s (roofline.py::separable_filter_bound); ~2 x 5 x 2 FLOP an
// output pixel is far below the f32 rate. Bytes bind.
//
// Design. A CTA an output tile of 64 x 16 pixels, 256 threads. The input
// rows and columns the tile needs, with a halo of 4 (9 taps at most), go
// into shared memory once, coalesced along rows, with indices clamped to
// the image (the replicated edge: a pass over the clamped input equals
// the plain version's pass over its padded one, so the second pass's own
// replication is the first's at the clamped index). The first pass writes
// its f32 result to shared memory, for the tile's output rows only (y
// first) or its output columns only (x first), so at stride 2 only the
// kept rows and columns are ever computed; the second pass reads it there
// and writes the tile. The taps reach the kernel by value, read in place
// as a __grid_constant__ parameter.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 64;        // output columns a CTA
constexpr int kTileH = 16;        // output rows a CTA
constexpr int kHalo = 4;          // the largest |tap offset|
constexpr int kMaxTaps = 9;
// the input region of a tile at stride 2 (the larger)
constexpr int kInH = 2 * (kTileH - 1) + 2 * kHalo + 1;
constexpr int kInW = 2 * (kTileW - 1) + 2 * kHalo + 1;
constexpr int kMid = (kInH * kTileW > kTileH * kInW) ? kInH * kTileW
                                                      : kTileH * kInW;

struct Pass {
  int n;                  // non-zero taps
  int off[kMaxTaps];      // their offsets, in tap order
  float w[kMaxTaps];      // their weights
};

struct Params {
  const float* in;
  float* out;
  int H, W;               // input
  int Ho, Wo;             // output
  int stride;             // 1 or 2
  int x_first;
  Pass py, px;            // the taps along y and along x
};

__device__ __forceinline__ float fir(const Pass& t, const float* src,
                                     int step) {
  float acc = 0.0f;
  for (int k = 0; k < t.n; ++k)
    acc = __fadd_rn(acc, __fmul_rn(t.w[k], src[t.off[k] * step]));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
separable_filter_kernel(const __grid_constant__ Params p) {
  __shared__ float in[kInH * kInW];
  __shared__ float mid[kMid];
  const int s = p.stride;
  const int oy0 = blockIdx.y * kTileH, ox0 = blockIdx.x * kTileW;
  const int ih = s * (kTileH - 1) + 2 * kHalo + 1;
  const int iw = s * (kTileW - 1) + 2 * kHalo + 1;
  const int r0 = s * oy0 - kHalo, c0 = s * ox0 - kHalo;
  for (int i = threadIdx.x; i < ih * iw; i += kThreads) {
    const int r = min(max(r0 + i / iw, 0), p.H - 1);
    const int c = min(max(c0 + i % iw, 0), p.W - 1);
    in[i] = p.in[static_cast<int64_t>(r) * p.W + c];
  }
  __syncthreads();
  if (!p.x_first) {
    // mid[ty][c]: the y pass at the tile's output rows, every column
    for (int i = threadIdx.x; i < kTileH * iw; i += kThreads) {
      const int ty = i / iw, c = i % iw;
      mid[i] = fir(p.py, &in[(s * ty + kHalo) * iw + c], iw);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
      const int ty = i / kTileW, tx = i % kTileW;
      const int oy = oy0 + ty, ox = ox0 + tx;
      if (oy < p.Ho && ox < p.Wo)
        p.out[static_cast<int64_t>(oy) * p.Wo + ox] =
            fir(p.px, &mid[ty * iw + s * tx + kHalo], 1);
    }
  } else {
    // mid[r][tx]: the x pass at every row, the tile's output columns
    for (int i = threadIdx.x; i < ih * kTileW; i += kThreads) {
      const int r = i / kTileW, tx = i % kTileW;
      mid[i] = fir(p.px, &in[r * iw + s * tx + kHalo], 1);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
      const int ty = i / kTileW, tx = i % kTileW;
      const int oy = oy0 + ty, ox = ox0 + tx;
      if (oy < p.Ho && ox < p.Wo)
        p.out[static_cast<int64_t>(oy) * p.Wo + ox] =
            fir(p.py, &mid[(s * ty + kHalo) * kTileW + tx], kTileW);
    }
  }
}

bool pack_pass(Pass& t, int n, const int* off, const float* w) {
  if (n < 0 || n > kMaxTaps) return false;
  t.n = n;
  for (int k = 0; k < n; ++k) {
    if (off[k] < -kHalo || off[k] > kHalo) return false;
    t.off[k] = off[k];
    t.w[k] = w[k];
  }
  return true;
}

}  // namespace

// Launches the kernel on `stream`; returns the CUDA error code (0: none),
// -1 for arguments it does not take. `in` is an (H, W) f32 image, `out`
// (ceil(H / stride), ceil(W / stride)); offy/wy and offx/wx are host
// arrays of ny and nx non-zero taps (offsets in [-4, 4], tap order).
extern "C" int separable_filter_launch(const void* in, int H, int W,
                                       int stride, int x_first, int ny,
                                       const void* offy, const void* wy,
                                       int nx, const void* offx,
                                       const void* wx, void* out,
                                       void* stream) {
  if (H < 1 || W < 1 || (stride != 1 && stride != 2)) return -1;
  Params p{};
  if (!pack_pass(p.py, ny, static_cast<const int*>(offy),
                 static_cast<const float*>(wy)) ||
      !pack_pass(p.px, nx, static_cast<const int*>(offx),
                 static_cast<const float*>(wx)))
    return -1;
  p.in = static_cast<const float*>(in);
  p.out = static_cast<float*>(out);
  p.H = H;
  p.W = W;
  p.stride = stride;
  p.Ho = (H + stride - 1) / stride;
  p.Wo = (W + stride - 1) / stride;
  p.x_first = x_first;
  const dim3 grid((p.Wo + kTileW - 1) / kTileW, (p.Ho + kTileH - 1) / kTileH);
  separable_filter_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
