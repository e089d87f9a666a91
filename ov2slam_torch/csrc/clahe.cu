// Contrast-limited adaptive histogram equalisation (CLAHE) in one kernel:
// each blend cell's cluster of four CTAs computes the lookup tables of the
// (up to) four tiles the cell blends, one a CTA, shares them through
// distributed shared memory, and blends the cell's pixels.
//
// Replaces the XLA-compiled form of ov2slam_tpu/core/image.py::clahe
// (:98), which the JAX package fuses into its jitted tracking and mapping
// steps. No Pallas kernel stands behind it. The plain PyTorch version is
// core/image.py::clahe_plain; this kernel computes what it computes:
//
//   a tile's LUT (ty x tx tiles of th x tw pixels, the image's bottom rows
//   and right columns replicated to fill them): the histogram of the
//   tile's values cast to int64 and clamped to [0, nbins - 1]; the excess
//   over the clip limit, summed; each bin clipped and the excess / nbins
//   added; the CDF; the LUT (cdf - cdf[0]) / max(cdf[-1] - cdf[0], 1) *
//   (nbins - 1);
//   a pixel's value: the tile coordinates fy = (y - th / 2 + 0.5) / th
//   (and fx), the tiles y0 = clamp(floor(fy), 0, ty - 1), y1 = min(y0 + 1,
//   ty - 1) (and x0, x1) and the weights, clamped, and the blend of the
//   four LUT values at the pixel's bin, in the plain version's order.
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
//    lanes' sums meet by __shfl_down at offsets 16, 8, 4, 2, 1. The kernel
//    sums in that order (the wrapper refuses other shapes). Where the clip
//    limit has few fractional bits (1/32 at 752x480 with clip 3) the
//    terms' sum is exact in any order; a limit such as 2.7 x 1488 / 256 at
//    377x241 is not, and there the order decides the bits;
//  - torch.cumsum over the last dimension runs scan_innermost_dim
//    (ATen/native/cuda/ScanUtils.cuh): 2^log_x threads a row, chunks of
//    2^(log_x + 1) bins, the running total added to a chunk's first bin,
//    then a Sklansky scan in log_x + 1 rounds. The kernel takes log_x
//    (get_log_num_threads_x_inner_scan of the (tiles, nbins) shape, 5 for
//    64 x 256) and scans in that order.
// The histogram's counts are exact integers, summed in any order. A LUT
// computed on several CTAs is the same function of the same tile. At a
// cell's top and left edges (floor(fy) < 0) the plain version's second
// tile has weight exactly +0, and a LUT value is finite and >= +0, so its
// term is +0 whatever tile it comes from, and adding +0 to a sum of such
// terms leaves its bits; there the cell takes the first tile's LUT for
// both. So every output is the plain version's on the card bit for bit.
// Never build this file with --use_fast_math.
//
// Bound on an H100 SXM. The image read once and the output written once:
// at 752x480 2.89 MB, 0.00086 ms at 3.35 TB/s; ~12 MFLOP, 0.00019 ms at
// 67 TFLOP/s (roofline.py::clahe_bound). Bytes bind. At this size the
// latency of the dependent stages (the tile's loads, histogram, excess,
// scan, LUT, blend) binds long before the bytes do.
//
// Design. A blend cell is the set of pixels with one clamped tile
// coordinate k = clamp(floor(f), -1, t - 1) each way: (ty + 1) x (tx + 1)
// cells, a whole tile inside, half tiles at the edges. A cluster of four
// CTAs (256 threads each) a cell: CTA r computes the cell's r-th tile's
// LUT (of up to four: its tiles (k, k + 1) each way, one at an edge).
//  - Each thread first loads the pixels it will blend (every fourth row
//    of the cell's window, from row r) into registers, so that those
//    loads wait behind the LUT's work and not after it.
//  - The tile: each warp loads 4 of its rows by 3 of its 32-column chunks
//    at once, and counts a lane's pixels as runs of one bin, a run one
//    shared-memory atomic into the warp's own integer sub-histogram (a
//    flat tile puts most pixels in one bin, and lanes that hit one address
//    in one atomic are served one after another), the warp's last runs of
//    its first lane's bin summed into one atomic; the eight are summed
//    (integers: exact in any order).
//  - One warp takes the excess in torch.sum's order; all threads clip;
//    one warp scans in torch.cumsum's order in registers: while a chunk
//    (2^(log_x + 1) bins) fits a warp, lane l holds the chunk's bins 2l
//    and 2l + 1 and each Sklansky round is one __shfl_sync (the same
//    pairs, operands and rounds as the block-wide scan); larger chunks
//    take the block-wide scan. All threads compute the LUT and write it
//    into its slot in every CTA of the cluster (distributed shared
//    memory, once the cluster's CTAs have all started); one cluster
//    barrier, and each CTA blends its rows from its own shared memory.
// Each tile's LUT is computed by up to four clusters; no global scratch,
// no second kernel, no global atomics. All 324 CTAs (752x480, 8 x 8
// tiles) are resident at once: a larger CTA or more registers a thread
// splits the grid into two waves and doubles the time (PERF.md).

#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;                // CTAs a cell, one a LUT
// a thread's tile loads in flight at once: kTileRows rows (of a warp's)
// by kTileCols columns (of a lane's)
constexpr int kTileRows = 4, kTileCols = 3;
// the blend pixels a thread holds in registers: rows (of a warp's) and
// columns (of a lane's), enough for tiles up to 4 * 8 * 4 - 5 = 123 rows
// and 4 * 32 - 5 = 123 columns; larger ones are read in the blend
constexpr int kHeldRows = 4, kHeldCols = 4;
constexpr int kMaxBins = 1024;
constexpr int kMaxLogX = 7;                // the block scan's 2^log_x threads
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* img;
  int H, W;
  int ty, tx;             // tiles each way
  int th, tw;             // tile size, ceil(H / ty), ceil(W / tx)
  int nbins;
  float limit;            // the clip limit, rounded to f32
  int log_x;              // torch's scan threads a row, log2
  float* out;             // (H, W)
};

// the plain version's clamp(v.long(), 0, nbins - 1), clamped in f32
// first: the same bin for every v (a NaN casts to 0 either way), without
// the 64-bit conversion
__device__ __forceinline__ int bin_of(float v, int nbins) {
  return static_cast<int>(
      fminf(fmaxf(v, 0.0f), static_cast<float>(nbins - 1)));
}

// torch's clamp: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// a tile coordinate: (v - t / 2 + 0.5) * rcp, rcp = 1 / t rounded to f32
__device__ __forceinline__ float tile_coord(int v, int t, float rcp) {
  const float half = static_cast<float>(t / 2.0);
  return __fmul_rn(__fadd_rn(__fsub_rn(static_cast<float>(v), half), 0.5f),
                   rcp);
}

// the plain version's clamp(floor(f).long(), 0, n - 1)
__device__ __forceinline__ int tile_of(float f, int n) {
  const long long fl = static_cast<long long>(floorf(f));
  return static_cast<int>(fl < 0 ? 0 : (fl > n - 1 ? n - 1 : fl));
}

// shared memory bytes a launch needs: the warps' sub-histograms, the
// CTA's LUT, the block-wide scan's buffer and the cell's four LUTs
inline int smem_bytes(int nbins, int log_x) {
  return static_cast<int>(sizeof(int)) * kWarps * nbins +
         static_cast<int>(sizeof(float)) *
             (nbins + (2 << log_x) + kCluster * nbins);
}

// The excess over the limit of the histogram `h` (counts as floats) in
// torch.sum's order (see the note above), on one warp; every lane returns
// it.
__device__ __forceinline__ float excess_sum(const float* h, int nb,
                                            float limit, int lane) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int v = lane; 4 * v + 3 < nb; v += 32)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i] = __fadd_rn(acc[i],
                         clamp_min(__fsub_rn(h[4 * v + i], limit), 0.0f));
  float e = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  for (int o = 16; o > 0; o >>= 1)
    e = __fadd_rn(e, __shfl_down_sync(kFull, e, o));
  return __shfl_sync(kFull, e, 0);
}

// torch.cumsum's order on the card (scan_innermost_dim) over `buf` in
// place, on one warp, for chunks of 2nx = 2^(log_x + 1) <= 64 bins: lane l
// < nx holds a chunk's bins 2l and 2l + 1
__device__ __forceinline__ void scan_warp(float* buf, int nb, int log_x,
                                          int lane) {
  const int nx = 1 << log_x;
  const bool act = lane < nx;
  float total = 0.0f;
  for (int col = 0; col < nb; col += 2 * nx) {
    const int i0 = col + 2 * lane, i1 = i0 + 1;
    float e0 = act && i0 < nb ? buf[i0] : 0.0f;
    float e1 = act && i1 < nb ? buf[i1] : 0.0f;
    if (lane == 0) e0 = __fadd_rn(e0, total);
    e1 = __fadd_rn(e1, e0);                       // round 0
    for (int m = 1; m <= log_x; ++m) {
      const int half = 1 << (m - 1);
      const float x = __shfl_sync(kFull, e1,
                                  (lane & ~((2 << (m - 1)) - 1)) + half - 1);
      if (lane & half) {
        e0 = __fadd_rn(e0, x);
        e1 = __fadd_rn(e1, x);
      }
    }
    if (act && i0 < nb) buf[i0] = e0;
    if (act && i1 < nb) buf[i1] = e1;
    total = __shfl_sync(kFull, e1, nx - 1);
  }
}

// the same on the whole block, for larger chunks (rb: 2nx floats)
__device__ void scan_block(float* buf, float* rb, int nb, int log_x) {
  const int tid = threadIdx.x, nx = 1 << log_x;
  float total = 0.0f;
  for (int col = 0; col < nb; col += 2 * nx) {
    for (int j = tid; j < 2 * nx; j += kThreads)
      rb[j] = col + j < nb ? buf[col + j] : 0.0f;
    __syncthreads();
    if (tid == 0) rb[0] = __fadd_rn(rb[0], total);
    __syncthreads();
    for (int m = 0; m <= log_x; ++m) {
      if (tid < nx) {
        const int s = 1 << m;
        const int a = ((tid >> m) << (m + 1)) | s;
        const int ti = a + (tid % s), si = a - 1;
        rb[ti] = __fadd_rn(rb[ti], rb[si]);
      }
      __syncthreads();
    }
    for (int j = tid; j < 2 * nx; j += kThreads)
      if (col + j < nb) buf[col + j] = rb[j];
    total = rb[2 * nx - 1];
    __syncthreads();
  }
}

// the LUT's first CDF value and range: cdf[0], max(cdf[-1] - cdf[0], 1)
__device__ __forceinline__ float2 cdf_ends(const float* buf, int nb) {
  const float first = buf[0];
  return make_float2(first,
                     clamp_min(__fsub_rn(buf[nb - 1], first), 1.0f));
}

// The cluster barrier in two halves: a CTA may write into another's
// shared memory only once that CTA has started (its arrival at entry).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// a cell's tiles along one axis: (first, count) for clamped tile
// coordinate k in [-1, n - 1]
__device__ __forceinline__ int2 cell_tiles(int k, int n) {
  const int first = max(k, 0), last = min(k + 1, n - 1);
  return make_int2(first, last - first + 1);
}

// the window of pixels (lo, hi) around cell k along an axis of `size`
// pixels in `n` tiles of `t`: every pixel of the cell lies inside
__device__ __forceinline__ int2 cell_window(int k, int n, int t, int size) {
  const int lo = k < 0 ? 0 : max(0, k * t + t / 2 - 2);
  const int hi = k >= n - 1 ? size : min(size, (k + 1) * t + t / 2 + 3);
  return make_int2(lo, hi);
}

// the plain version's clamp(floor(f).long(), -1, n - 1): the cell
__device__ __forceinline__ int cell_of(float f, int n) {
  const long long fl = static_cast<long long>(floorf(f));
  return static_cast<int>(fl < -1 ? -1 : (fl > n - 1 ? n - 1 : fl));
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
clahe_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float spread_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = p.nbins;
  int* sub = reinterpret_cast<int*>(smem);                   // [warp][bin]
  float* buf = reinterpret_cast<float*>(sub + kWarps * nb);   // this LUT
  float* rb = buf + nb;
  float* luts = rb + (2 << p.log_x);                          // [slot][bin]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cell = blockIdx.x / kCluster;
  const int ky = cell / (p.tx + 1) - 1, kx = cell % (p.tx + 1) - 1;
  const int2 ys = cell_tiles(ky, p.ty), xs = cell_tiles(kx, p.tx);
  const int tiles = ys.y * xs.y;
  cluster_arrive();

  // the pixels this CTA blends (every fourth row of the cell's window,
  // from row `rank`), loaded now into registers where they fit, so that
  // their loads overlap the LUT's work
  const int2 wy_ = cell_window(ky, p.ty, p.th, p.H);
  const int2 wx_ = cell_window(kx, p.tx, p.tw, p.W);
  const int rows = max(0, (wy_.y - wy_.x - rank + kCluster - 1) / kCluster);
  const bool held = rows <= kHeldRows * kWarps &&
                    wx_.y - wx_.x <= kHeldCols * 32;
  float px[kHeldRows][kHeldCols];
  if (held) {
#pragma unroll
    for (int r = 0; r < kHeldRows; ++r)
#pragma unroll
      for (int c = 0; c < kHeldCols; ++c) {
        const int j = warp + kWarps * r, x = wx_.x + lane + 32 * c;
        px[r][c] = j < rows && x < wx_.y
                       ? __ldg(p.img + static_cast<int64_t>(
                                   wy_.x + rank + kCluster * j) * p.W + x)
                       : 0.0f;
      }
  }

  // this CTA's tile: its padded pixels' histogram, then the LUT, written
  // into slot `rank` of every CTA of the cluster
  if (rank < tiles) {
    for (int i = tid; i < kWarps * nb; i += kThreads) sub[i] = 0;
    __syncthreads();
    const int y0 = (ys.x + rank / xs.y) * p.th;
    const int x0 = (xs.x + rank % xs.y) * p.tw;
    int* h = sub + warp * nb;
    // a thread's pixels counted as runs of one bin, each run one atomic
    int run_bin = -1, run_n = 0;
    for (int r0 = warp; r0 < p.th; r0 += kWarps * kTileRows)
      for (int c0 = lane; c0 < p.tw; c0 += 32 * kTileCols) {
        float v[kTileRows][kTileCols];
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) {
          const float* row =
              p.img + static_cast<int64_t>(min(y0 + r0 + kWarps * i,
                                               p.H - 1)) * p.W;
#pragma unroll
          for (int j = 0; j < kTileCols; ++j) {
            const bool in = r0 + kWarps * i < p.th && c0 + 32 * j < p.tw;
            v[i][j] = in ? __ldg(row + min(x0 + c0 + 32 * j, p.W - 1))
                         : -1.0f;
          }
        }
#pragma unroll
        for (int i = 0; i < kTileRows; ++i)
#pragma unroll
          for (int j = 0; j < kTileCols; ++j) {
            if (r0 + kWarps * i >= p.th || c0 + 32 * j >= p.tw) continue;
            const int b = bin_of(v[i][j], nb);
            if (b != run_bin) {
              if (run_n > 0) atomicAdd(&h[run_bin], run_n);
              run_bin = b;
              run_n = 0;
            }
            ++run_n;
          }
      }
    // the last runs: those of the first lane's bin summed over the warp
    // into one atomic, the others one each
    const unsigned todo = __ballot_sync(kFull, run_n > 0);
    if (todo != 0) {
      const int lb = __shfl_sync(kFull, run_bin, __ffs(todo) - 1);
      const bool same = run_n > 0 && run_bin == lb;
      int c = same ? run_n : 0;
      for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
      if (lane == 0) atomicAdd(&h[lb], c);
      if (run_n > 0 && !same) atomicAdd(&h[run_bin], run_n);
    }
    __syncthreads();
    for (int b = tid; b < nb; b += kThreads) {
      int c = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) c += sub[k * nb + b];
      buf[b] = static_cast<float>(c);
    }
    __syncthreads();
    if (warp == 0) {
      const float e = excess_sum(buf, nb, p.limit, lane);
      if (lane == 0)
        spread_s = __fmul_rn(e, __fdiv_rn(1.0f, static_cast<float>(nb)));
    }
    __syncthreads();
    const float spread = spread_s;
    for (int b = tid; b < nb; b += kThreads)
      buf[b] = __fadd_rn(clamp_max(buf[b], p.limit), spread);
    __syncthreads();
    if (p.log_x <= 5) {
      if (warp == 0) scan_warp(buf, nb, p.log_x, lane);
      __syncthreads();
    } else {
      scan_block(buf, rb, nb, p.log_x);
    }
  }
  cluster_wait();
  if (rank < tiles) {
    const float2 ends = cdf_ends(buf, nb);
    const float top = static_cast<float>(nb - 1.0);
    for (int b = tid; b < nb; b += kThreads) {
      const float v = __fmul_rn(
          __fdiv_rn(__fsub_rn(buf[b], ends.x), ends.y), top);
#pragma unroll
      for (int t = 0; t < kCluster; ++t)
        cluster.map_shared_rank(luts, t)[rank * nb + b] = v;
    }
  }
  // every LUT of the cell in every CTA of its cluster
  cluster.sync();

  // the blend; where the cell has one tile along an axis, that tile's LUT
  // stands for both (see above)
  const float* l00 = luts;
  const float* l01 = luts + (xs.y - 1) * nb;
  const float* l10 = luts + (ys.y - 1) * xs.y * nb;
  const float* l11 = luts + ((ys.y - 1) * xs.y + xs.y - 1) * nb;
  const float rcp_th = __fdiv_rn(1.0f, static_cast<float>(p.th));
  const float rcp_tw = __fdiv_rn(1.0f, static_cast<float>(p.tw));
  auto blend = [&](int y, int x, float value, float wy, float oy) {
    const float fx = tile_coord(x, p.tw, rcp_tw);
    if (cell_of(fx, p.tx) != kx) return;
    const int x0 = tile_of(fx, p.tx);
    const float wx = clamp_max(
        clamp_min(__fsub_rn(fx, static_cast<float>(x0)), 0.0f), 1.0f);
    const float ox = __fsub_rn(1.0f, wx);
    const int b = bin_of(value, nb);
    float v = __fmul_rn(__fmul_rn(l00[b], oy), ox);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(l01[b], oy), wx));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(l10[b], wy), ox));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(l11[b], wy), wx));
    p.out[static_cast<int64_t>(y) * p.W + x] = v;
  };
  for (int j = warp, r = 0; j < rows; j += kWarps, ++r) {
    const int y = wy_.x + rank + kCluster * j;
    const float fy = tile_coord(y, p.th, rcp_th);
    if (cell_of(fy, p.ty) != ky) continue;
    const int y0 = tile_of(fy, p.ty);
    const float wy = clamp_max(
        clamp_min(__fsub_rn(fy, static_cast<float>(y0)), 0.0f), 1.0f);
    const float oy = __fsub_rn(1.0f, wy);
    if (held) {
#pragma unroll
      for (int rr = 0; rr < kHeldRows; ++rr) {
        if (rr != r) continue;
#pragma unroll
        for (int c = 0; c < kHeldCols; ++c) {
          const int x = wx_.x + lane + 32 * c;
          if (x < wx_.y) blend(y, x, px[rr][c], wy, oy);
        }
      }
    } else {
      for (int x = wx_.x + lane; x < wx_.y; x += 32)
        blend(y, x, __ldg(p.img + static_cast<int64_t>(y) * p.W + x), wy,
              oy);
    }
  }
}

}  // namespace

// Sets what the kernel needs before its first launch (dynamic shared
// memory for the largest bins it takes); called once when the library is
// loaded. Returns the CUDA error code (0: none).
extern "C" int clahe_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      clahe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxBins, kMaxLogX)));
}

// Launches the kernel on `stream`; returns the CUDA error code (0: none),
// -1 for arguments it does not take (fewer than 16 tiles, or nbins not a
// multiple of 4 from 128 to 1024: torch.sum sums those in another order).
// `img` and `out` are (H, W) f32; `limit` is the clip limit as the plain
// version's Python float rounds to f32.
extern "C" int clahe_launch(const void* img, int H, int W, int ty, int tx,
                            int nbins, float limit, int log_x, void* out,
                            void* stream) {
  if (H < 1 || W < 1 || ty < 1 || tx < 1 || ty * tx < 16 || nbins < 128 ||
      nbins % 4 != 0 || nbins > kMaxBins || log_x < 0 || log_x > kMaxLogX)
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
  p.out = static_cast<float*>(out);
  clahe_kernel<<<(ty + 1) * (tx + 1) * kCluster, kThreads,
                 smem_bytes(nbins, log_x),
                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
