// Contrast-limited adaptive histogram equalisation (CLAHE) in two kernels:
// the tiles' lookup tables, then their bilinear blend at every pixel.
//
// Replaces the XLA-compiled form of ov2slam_tpu/core/image.py::clahe
// (:98), which the JAX package fuses into its jitted tracking and mapping
// steps. No Pallas kernel stands behind it. The plain PyTorch version is
// core/image.py::clahe_plain; these kernels compute what it computes:
//
//   clahe_lut_kernel, a CTA a tile (ty x tx tiles of th x tw pixels, the
//   image's bottom rows and right columns replicated to fill them): the
//   histogram of the tile's values cast to int64 and clamped to
//   [0, nbins - 1]; the excess over the clip limit, summed; each bin
//   clipped and the excess / nbins added; the CDF; the LUT
//   (cdf - cdf[0]) / max(cdf[-1] - cdf[0], 1) * (nbins - 1);
//   clahe_apply_kernel, a thread a pixel: the tile coordinates
//   fy = (y - th / 2 + 0.5) / th (and fx), the two tiles each way and the
//   weights, clamped, and the blend of the four LUT values at the pixel's
//   bin, in the plain version's order.
//
// Rounding. Each torch operation of the plain version rounds once in IEEE
// f32; here each is the intrinsic that rounds it, in the same order. Where
// the eager path is not what its Python reads as:
//  - a division by a Python number (`/ th`, `/ tw`, `excess / nbins`) is,
//    on the card, a product with the reciprocal rounded to f32 first
//    (div_true_kernel_cuda); the division by a tensor (the CDF's range) is
//    an IEEE division;
//  - a Python scalar (the clip limit, 255.0) is rounded to f32 before it
//    meets a tensor;
//  - torch.sum over the last dimension of the (tiles, nbins) excess runs
//    ATen's reduce kernel (ATen/native/cuda/Reduce.cuh): for 16 tiles or
//    more and nbins a multiple of 4 from 128 to 1024, one warp a row, the
//    input vectorised by 4: lane l keeps four sums, of bins 4v + i over
//    the vectors v = l, l + 32, ..., adds them in order i = 0..3, then the
//    lanes' sums meet by __shfl_down at offsets 16, 8, 4, 2, 1. The LUT
//    kernel sums in that order (the wrapper refuses other shapes). Where
//    the clip limit has few fractional bits (1/32 at 752x480 with clip 3)
//    the terms' sum is exact in any order; a limit such as 2.7 x 1488 /
//    256 at 377x241 is not, and there the order decides the bits;
//  - torch.cumsum over the last dimension runs scan_innermost_dim
//    (ATen/native/cuda/ScanUtils.cuh): 2^log_x threads a row, chunks of
//    2^(log_x + 1) bins, the running total added to a chunk's first bin,
//    then a Sklansky scan in log_x + 1 rounds. The LUT kernel takes log_x
//    (get_log_num_threads_x_inner_scan of the (tiles, nbins) shape, 5 for
//    64 x 256) and scans in that order.
// The histogram's counts are exact integers. So every output is the plain
// version's on the card bit for bit. Never build this file with
// --use_fast_math.
//
// Bound on an H100 SXM. The image read once and the output written once:
// at 752x480 2.89 MB, 0.00086 ms at 3.35 TB/s; ~12 MFLOP, 0.00019 ms at
// 67 TFLOP/s (roofline.py::clahe_bound). Bytes bind. The kernels read the
// image twice (the histogram, the blend; 4.33 MB moved) and keep the LUTs
// (64 KB) in L2; the LUT kernel runs on 64 SMs, its scan a chain of 4 x 6
// dependent rounds.
//
// Design. The LUT kernel: one CTA of 512 threads a tile; the histogram in
// shared memory by shared-memory atomics on integer counts (exact in any
// order); the excess on one warp in torch.sum's order; the scan and the
// LUT in shared memory, written to a (tiles, nbins) f32 scratch the
// wrapper allocates. The blend kernel: a thread a pixel, the four LUT
// values read through the read-only cache. No global atomics, no tickets.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLutThreads = 512;
constexpr int kApplyThreads = 256;
constexpr int kMaxBins = 1024;

struct Params {
  const float* img;
  int H, W;
  int ty, tx;             // tiles each way
  int th, tw;             // tile size, ceil(H / ty), ceil(W / tx)
  int nbins;
  float limit;            // the clip limit, rounded to f32
  int log_x;              // torch's scan threads a row, log2
  float* lut;             // (ty * tx, nbins)
  float* out;             // (H, W)
};

__device__ __forceinline__ int bin_of(float v, int nbins) {
  const long long b = static_cast<long long>(v);
  return static_cast<int>(b < 0 ? 0 : (b > nbins - 1 ? nbins - 1 : b));
}

// torch's clamp: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__global__ void __launch_bounds__(kLutThreads)
clahe_lut_kernel(const Params p) {
  __shared__ int hist[kMaxBins];
  __shared__ float buf[kMaxBins];
  __shared__ float cdf[kMaxBins];
  __shared__ float rb[kMaxBins];        // torch's row_buf
  __shared__ float excess_sum;
  const int tid = threadIdx.x, nb = p.nbins;
  const int tile = blockIdx.x;
  const int y0 = (tile / p.tx) * p.th, x0 = (tile % p.tx) * p.tw;
  for (int b = tid; b < nb; b += kLutThreads) hist[b] = 0;
  __syncthreads();
  const int npx = p.th * p.tw;
  for (int i = tid; i < npx; i += kLutThreads) {
    const int y = min(y0 + i / p.tw, p.H - 1);
    const int x = min(x0 + i % p.tw, p.W - 1);
    atomicAdd(&hist[bin_of(p.img[static_cast<int64_t>(y) * p.W + x], nb)],
              1);
  }
  __syncthreads();

  // the excess over the limit, in torch.sum's order (see the note above)
  if (tid < 32) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int v = tid; 4 * v + 3 < nb; v += 32)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = __fadd_rn(acc[i], clamp_min(__fsub_rn(
            static_cast<float>(hist[4 * v + i]), p.limit), 0.0f));
    float e = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]),
                        acc[3]);
    for (int o = 16; o > 0; o >>= 1)
      e = __fadd_rn(e, __shfl_down_sync(0xffffffffu, e, o));
    if (tid == 0) excess_sum = e;
  }
  __syncthreads();
  const float excess = excess_sum;
  const float spread = __fmul_rn(excess,
                                 __fdiv_rn(1.0f, static_cast<float>(nb)));
  for (int b = tid; b < nb; b += kLutThreads)
    buf[b] = __fadd_rn(clamp_max(static_cast<float>(hist[b]), p.limit),
                       spread);
  __syncthreads();

  // torch.cumsum's order on the card (scan_innermost_dim)
  const int nx = 1 << p.log_x;
  float total = 0.0f;
  for (int col = 0; col < nb; col += 2 * nx) {
    for (int j = tid; j < 2 * nx; j += kLutThreads)
      rb[j] = col + j < nb ? buf[col + j] : 0.0f;
    __syncthreads();
    if (tid == 0) rb[0] = __fadd_rn(rb[0], total);
    __syncthreads();
    for (int m = 0; m <= p.log_x; ++m) {
      if (tid < nx) {
        const int s = 1 << m;
        const int a = ((tid >> m) << (m + 1)) | s;
        const int ti = a + (tid % s), si = a - 1;
        rb[ti] = __fadd_rn(rb[ti], rb[si]);
      }
      __syncthreads();
    }
    for (int j = tid; j < 2 * nx; j += kLutThreads)
      if (col + j < nb) cdf[col + j] = rb[j];
    total = rb[2 * nx - 1];
    __syncthreads();
  }

  const float first = cdf[0];
  const float range = clamp_min(__fsub_rn(cdf[nb - 1], first), 1.0f);
  const float top = static_cast<float>(nb - 1.0);
  float* lut = p.lut + static_cast<int64_t>(tile) * nb;
  for (int b = tid; b < nb; b += kLutThreads)
    lut[b] = __fmul_rn(__fdiv_rn(__fsub_rn(cdf[b], first), range), top);
}

// a tile coordinate: (v - t / 2 + 0.5) * (1 / t), the reciprocal in f32
__device__ __forceinline__ float tile_coord(int v, int t) {
  const float half = static_cast<float>(t / 2.0);
  return __fmul_rn(__fadd_rn(__fsub_rn(static_cast<float>(v), half), 0.5f),
                   __fdiv_rn(1.0f, static_cast<float>(t)));
}

__global__ void __launch_bounds__(kApplyThreads)
clahe_apply_kernel(const Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kApplyThreads +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(p.H) * p.W) return;
  const int y = static_cast<int>(i / p.W), x = static_cast<int>(i % p.W);
  const float fy = tile_coord(y, p.th), fx = tile_coord(x, p.tw);
  const long long fly = static_cast<long long>(floorf(fy));
  const long long flx = static_cast<long long>(floorf(fx));
  const int y0 = static_cast<int>(fly < 0 ? 0 : (fly > p.ty - 1 ? p.ty - 1
                                                                 : fly));
  const int x0 = static_cast<int>(flx < 0 ? 0 : (flx > p.tx - 1 ? p.tx - 1
                                                                 : flx));
  const int y1 = min(y0 + 1, p.ty - 1), x1 = min(x0 + 1, p.tx - 1);
  const float wy = clamp_max(clamp_min(__fsub_rn(fy, static_cast<float>(y0)),
                                       0.0f), 1.0f);
  const float wx = clamp_max(clamp_min(__fsub_rn(fx, static_cast<float>(x0)),
                                       0.0f), 1.0f);
  const int nb = p.nbins;
  const int b = bin_of(p.img[i], nb);
  const float v00 = __ldg(&p.lut[(y0 * p.tx + x0) * nb + b]);
  const float v01 = __ldg(&p.lut[(y0 * p.tx + x1) * nb + b]);
  const float v10 = __ldg(&p.lut[(y1 * p.tx + x0) * nb + b]);
  const float v11 = __ldg(&p.lut[(y1 * p.tx + x1) * nb + b]);
  const float oy = __fsub_rn(1.0f, wy), ox = __fsub_rn(1.0f, wx);
  float v = __fmul_rn(__fmul_rn(v00, oy), ox);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, oy), wx));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), ox));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
  p.out[i] = v;
}

}  // namespace

// Launches both kernels on `stream`; returns the CUDA error code (0:
// none), -1 for arguments they do not take (fewer than 16 tiles, or nbins
// not a multiple of 4 from 128 to 1024: torch.sum sums those in another
// order). `img` and `out` are (H, W) f32, `lut` a (ty * tx, nbins) f32
// scratch; `limit` is the clip limit as the plain version's Python float
// rounds to f32.
extern "C" int clahe_launch(const void* img, int H, int W, int ty, int tx,
                            int nbins, float limit, int log_x, void* lut,
                            void* out, void* stream) {
  if (H < 1 || W < 1 || ty < 1 || tx < 1 || ty * tx < 16 || nbins < 128 ||
      nbins % 4 != 0 || nbins > kMaxBins || log_x < 0 ||
      (2 << log_x) > kMaxBins)
    return -1;
  Params p{};
  p.img = static_cast<const float*>(img);
  p.H = H;
  p.W = W;
  p.ty = ty;
  p.tx = tx;
  p.th = (H + ty - 1) / ty;
  p.tw = (W + tx - 1) / tx;
  p.nbins = nbins;
  p.limit = limit;
  p.log_x = log_x;
  p.lut = static_cast<float*>(lut);
  p.out = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  clahe_lut_kernel<<<ty * tx, kLutThreads, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(H) * W;
  clahe_apply_kernel<<<static_cast<unsigned>((n + kApplyThreads - 1) /
                                             kApplyThreads),
                       kApplyThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
