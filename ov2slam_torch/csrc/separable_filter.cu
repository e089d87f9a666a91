// Separable FIR filters over an edge-replicated image: one filtered (or
// 2x decimated) image a launch, a whole Gaussian pyramid (up to three
// levels below its base) a launch, and Scharr's two gradients a launch.
//
// Replaces the XLA-compiled form of ov2slam_tpu/core/image.py's _filter_x
// (:24) and _filter_y (:36), the shift-add FIRs that separable_filter
// (:47), gaussian_blur (:57), box_filter (:63), scharr_gradients (:68),
// pyr_down (:78) and build_pyramid (:84) chain, which the JAX package
// fuses into its jitted steps. No Pallas kernel stands behind them. The
// plain PyTorch version is core/image.py::separable_filter_plain (and the
// pyramid and Scharr's pair are its calls in turn); these kernels compute
// what it computes:
//
//   mid = the first pass (along y, or along x where `x_first` is set, as
//   scharr_gradients' gy is) of the image, out = the second pass of mid
//   along the other axis, each pass out = sum over the non-zero taps t_i,
//   in tap order, of t_i * p[i - r] (p the input of the pass, its edge
//   replicated, r = len(taps) // 2); at stride 2, out[::2, ::2]. A
//   pyramid level is the 5-tap [1 4 6 4 1] / 16 filter of the level above
//   at stride 2, y first; Scharr's gx is [3 10 3] / 16 along y then
//   [-1 0 1] / 2 along x, gy the same taps the other way round, x first.
//
// Rounding. The plain version starts each pass's sum from zeros_like and
// adds one rounded product per non-zero tap, each its own torch operation;
// here each product is __fmul_rn and each sum __fadd_rn in the same tap
// order, from +0 (so a first product of -0 gives +0 there too), and the
// first pass's result is kept in f32. A value computed twice (a pyramid
// level's halo, on two CTAs) is the same sum of the same products, so
// every output is the plain version's on the card bit for bit. Never build
// this file with --use_fast_math.
//
// Bound on an H100 SXM. Each input read once and each output written
// once: a pyramid level of 752x480 moves 1.44 MB + 0.36 MB, 0.00054 ms at
// 3.35 TB/s; the whole 4-level pyramid 1.44 MB + 0.48 MB, 0.00057 ms; the
// Scharr pair 1.44 MB + 2 x 1.44 MB, 0.00129 ms (roofline.py::
// separable_filter_bound, pyramid_bound, scharr_pair_bound); ~2 x 9 x 2
// FLOP an output pixel is far below the f32 rate. Bytes bind; at these
// sizes a launch takes several times its bound in latency alone (the
// first touch of the image, a few barrier-separated stages), so the
// designs cut launches and dependent stages before bytes.
//
// Design.
//  - filter_kernel<S, NY, NX> (one image): a CTA an output tile (64 x 16
//    at stride 1, 32 x 8 at stride 2: 360 CTAs at 752x480 either way),
//    256 threads. The tile's input region with a halo of 4 (9 taps at
//    most) goes into shared memory once, row by row in float4s where the
//    row is 16-byte aligned and inside the image, else in clamped scalar
//    loads (the replicated edge: a pass over the clamped input equals the
//    plain version's pass over its padded one). The first pass writes its
//    f32 result to shared memory for the tile's output rows (y first) or
//    columns (x first) only; the second pass reads it there. The counts
//    of non-zero taps the package uses (9 for BRIEF's blur, 3 for the box
//    filter, 5 at stride 2 for pyr_down) are template arguments, so the
//    tap loops unroll; other counts take the generic form. Index arithmetic divides only by compile-time
//    constants. The taps reach the kernel by value, as a
//    __grid_constant__ parameter.
//  - pyramid_kernel (a pyramid, up to three levels below its source): a
//    CTA of 512 threads owns a tile of the coarsest level and the tiles of
//    every finer level above it (the tile scaled by 2, 4); it loads the
//    region of the source that the tile needs with all its halos (level
//    l's region is twice level l+1's plus 3) into dynamic shared memory,
//    a thread's loads all in flight at once, and computes each level's
//    region there in turn (the y pass at the level's rows, then the x
//    pass), writing the part of each level it owns. A region's positions
//    outside the level hold the level's value at the clamped position
//    (computed there again), so no pass clamps. The coarsest tile is
//    chosen in the launch so that the grid fills the card (8 x 4, 180
//    CTAs at 752x480; 8 x 8 and 16 x 8 were slower, PERF.md).
//    Deeper pyramids chain launches from the deepest level
//    (core/image.py::pyramid_plan).
//  - scharr_kernel (both gradients): a CTA a 64 x 16 tile of both, the
//    input region with a halo of 1 row (4 columns, for alignment) loaded
//    once; the y-smoothed rows for gx and the x-smoothed columns for gy,
//    then both second passes, each in its own pass order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 4;          // the largest |tap offset|
constexpr int kMaxTaps = 9;

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
  int x_first;
  int vec;                // rows 16-byte aligned: float4 loads
  Pass py, px;            // the taps along y and along x
};

// the sum over the pass's non-zero taps in tap order (N of them where N
// > 0, t.n at run time where N == 0)
template <int N>
__device__ __forceinline__ float fir(const Pass& t, const float* src,
                                     int step) {
  float acc = 0.0f;
  if (N > 0) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      acc = __fadd_rn(acc, __fmul_rn(t.w[k], src[t.off[k] * step]));
  } else {
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k)
      if (k < t.n)
        acc = __fadd_rn(acc, __fmul_rn(t.w[k], src[t.off[k] * step]));
  }
  return acc;
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// Loads the RH x RW region of `in` (H x W) at (r0, c0), indices clamped
// to the image, into `dst` (row stride RW, a multiple of 4). With `vec`
// (rows 16-byte aligned, c0 a multiple of 4) a quad inside the image is
// one float4 load.
template <int RH, int RW>
__device__ __forceinline__ void load_region(float* dst, const float* in,
                                            int H, int W, int r0, int c0,
                                            bool vec) {
  static_assert(RW % 4 == 0, "region rows are float4s");
  constexpr int Q = RW / 4;
  for (int i = threadIdx.x; i < RH * Q; i += kThreads) {
    const int r = i / Q, q = i % Q;
    const float* row = in + static_cast<int64_t>(clampi(r0 + r, H - 1)) * W;
    const int c = c0 + 4 * q;
    float4 v;
    if (vec && c >= 0 && c + 3 < W) {
      v = __ldg(reinterpret_cast<const float4*>(row + c));
    } else {
      v.x = __ldg(row + clampi(c, W - 1));
      v.y = __ldg(row + clampi(c + 1, W - 1));
      v.z = __ldg(row + clampi(c + 2, W - 1));
      v.w = __ldg(row + clampi(c + 3, W - 1));
    }
    *reinterpret_cast<float4*>(dst + r * RW + 4 * q) = v;
  }
}

// ------------------------------------------------------ one image ---

template <int S> struct Tile;
template <> struct Tile<1> { static constexpr int W = 64, H = 16; };
template <> struct Tile<2> { static constexpr int W = 32, H = 8; };

template <int S, int NY, int NX>
__global__ void __launch_bounds__(kThreads)
filter_kernel(const __grid_constant__ Params p) {
  constexpr int TW = Tile<S>::W, TH = Tile<S>::H;
  constexpr int IH = S * (TH - 1) + 2 * kHalo + 1;
  constexpr int IW = (S * (TW - 1) + 2 * kHalo + 1 + 3) / 4 * 4;
  constexpr int MID = (TH * IW > IH * TW) ? TH * IW : IH * TW;
  __shared__ __align__(16) float in[IH * IW];
  __shared__ float mid[MID];
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  load_region<IH, IW>(in, p.in, p.H, p.W, S * oy0 - kHalo, S * ox0 - kHalo,
                      p.vec != 0);
  __syncthreads();
  if (!p.x_first) {
    // mid[ty][c]: the y pass at the tile's output rows, every column
    for (int i = threadIdx.x; i < TH * IW; i += kThreads) {
      const int ty = i / IW, c = i % IW;
      mid[i] = fir<NY>(p.py, &in[(S * ty + kHalo) * IW + c], IW);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TH * TW; i += kThreads) {
      const int ty = i / TW, tx = i % TW;
      const int oy = oy0 + ty, ox = ox0 + tx;
      if (oy < p.Ho && ox < p.Wo)
        p.out[static_cast<int64_t>(oy) * p.Wo + ox] =
            fir<NX>(p.px, &mid[ty * IW + S * tx + kHalo], 1);
    }
  } else {
    // mid[r][tx]: the x pass at every row, the tile's output columns
    for (int i = threadIdx.x; i < IH * TW; i += kThreads) {
      const int r = i / TW, tx = i % TW;
      mid[i] = fir<NX>(p.px, &in[r * IW + S * tx + kHalo], 1);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TH * TW; i += kThreads) {
      const int ty = i / TW, tx = i % TW;
      const int oy = oy0 + ty, ox = ox0 + tx;
      if (oy < p.Ho && ox < p.Wo)
        p.out[static_cast<int64_t>(oy) * p.Wo + ox] =
            fir<NY>(p.py, &mid[(S * ty + kHalo) * TW + tx], TW);
    }
  }
}

using FilterFn = void (*)(Params);

// the instance for a stride and the passes' non-zero tap counts
FilterFn pick_filter(int s, int ny, int nx) {
#define OV2_CASE(S_, A_, B_) \
  if (s == S_ && ny == A_ && nx == B_) return filter_kernel<S_, A_, B_>;
  OV2_CASE(1, 9, 9)   // BRIEF's blur
  OV2_CASE(1, 3, 3)   // box_filter(3), Shi-Tomasi's
  OV2_CASE(2, 5, 5)   // pyr_down
#undef OV2_CASE
  return s == 1 ? filter_kernel<1, 0, 0> : filter_kernel<2, 0, 0>;
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

bool aligned_rows(const void* p, int W) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && W % 4 == 0;
}

// --------------------------------------------------------- pyramid ---

constexpr int kMaxOut = 3;        // levels a launch writes
constexpr int kPyrThreads = 512;
constexpr int kPyrBatch = 12;     // source loads a thread keeps in flight
// pyr_down's taps, [1 4 6 4 1] / 16 (exact in f32), offsets -2..2
__constant__ float kPyr[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};

struct PyrParams {
  const float* in;
  float* out[kMaxOut];
  int H[kMaxOut + 1], W[kMaxOut + 1];   // level sizes, the source first
  int nout;
  int th, tw;             // the coarsest level's tile
  int ry[kMaxOut + 1], rx[kMaxOut + 1]; // region sizes by level
  int mid_off;            // floats before the mid buffer
};

__device__ __forceinline__ float pyr5(const float* src, int step) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 5; ++k)
    acc = __fadd_rn(acc, __fmul_rn(kPyr[k], src[k * step]));
  return acc;
}

__global__ void __launch_bounds__(kPyrThreads)
pyramid_kernel(const __grid_constant__ PyrParams p) {
  extern __shared__ __align__(16) float smem[];
  float* lvl = smem;                  // a level's region
  float* mid = smem + p.mid_off;      // its y pass at the next level's rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kPyrThreads / 32;
  const int n = p.nout;
  // the regions' first row and column by level: level l's is twice level
  // l + 1's, less 2 (its halo)
  int y0[kMaxOut + 1], x0[kMaxOut + 1];
  y0[n] = blockIdx.y * p.th;
  x0[n] = blockIdx.x * p.tw;
  for (int l = n - 1; l >= 0; --l) {
    y0[l] = 2 * y0[l + 1] - 2;
    x0[l] = 2 * x0[l + 1] - 2;
  }
  // the source's region, at clamped indices: a thread's loads in batches
  // of kPyrBatch, all of a batch in flight at once
  {
    const int rx = p.rx[0], count = p.ry[0] * rx;
    for (int base = threadIdx.x; base < count;
         base += kPyrBatch * kPyrThreads) {
      float v[kPyrBatch];
#pragma unroll
      for (int k = 0; k < kPyrBatch; ++k) {
        const int i = min(base + k * kPyrThreads, count - 1);
        const int r = i / rx, c = i - r * rx;
        v[k] = __ldg(p.in +
                     static_cast<int64_t>(clampi(y0[0] + r, p.H[0] - 1)) *
                         p.W[0] +
                     clampi(x0[0] + c, p.W[0] - 1));
      }
#pragma unroll
      for (int k = 0; k < kPyrBatch; ++k)
        if (base + k * kPyrThreads < count)
          lvl[base + k * kPyrThreads] = v[k];
    }
  }
  __syncthreads();
  for (int l = 1; l <= n; ++l) {
    const int ry = p.ry[l], rx = p.rx[l], prx = p.rx[l - 1];
    const int H = p.H[l], W = p.W[l];
    // mid[r][c]: the y pass at row clamp(y0 + r) of level l, every column
    // of level l - 1's region (whose rows from 2 (q - y0) hold its rows
    // from 2 q - 2)
    for (int r = warp; r < ry; r += kWarps) {
      const int q = clampi(y0[l] + r, H - 1);
      const float* src = lvl + 2 * (q - y0[l]) * prx;
      float* dst = mid + r * prx;
#pragma unroll 4
      for (int c = lane; c < prx; c += 32) dst[c] = pyr5(src + c, prx);
    }
    __syncthreads();
    // level l at (clamp(y0 + r), clamp(x0 + c)): the x pass over mid;
    // written out where the CTA owns it
    const int s = n - l;                  // level l's tile: 2^s coarse
    const int oy0 = (blockIdx.y * p.th) << s, oy1 = min(oy0 + (p.th << s), H);
    const int ox0 = (blockIdx.x * p.tw) << s, ox1 = min(ox0 + (p.tw << s), W);
    float* out = p.out[l - 1];
    for (int r = warp; r < ry; r += kWarps) {
      const int y = y0[l] + r;
      const float* src = mid + r * prx;
      float* dst = lvl + r * rx;
      const bool own_row = y >= oy0 && y < oy1;
#pragma unroll 4
      for (int c = lane; c < rx; c += 32) {
        const int x = x0[l] + c;
        const int q = clampi(x, W - 1);
        const float v = pyr5(src + 2 * (q - x0[l]), 1);
        if (l < n) dst[c] = v;
        if (own_row && x >= ox0 && x < ox1)
          out[static_cast<int64_t>(y) * W + x] = v;
      }
    }
    __syncthreads();
  }
}

// coarsest-level tiles (columns, rows), largest first: the first whose
// grid fills the card is taken, else the last
constexpr int kPyrTiles[][2] = {{16, 8}, {8, 8}, {8, 4}, {4, 4}};
constexpr int kFillCtas = 132;

struct PyrShape {
  int th, tw;
  int ry[kMaxOut + 1], rx[kMaxOut + 1];
  int mid_off, floats;
};

PyrShape pyr_shape(int nout, int th, int tw) {
  PyrShape s{};
  s.th = th;
  s.tw = tw;
  s.ry[nout] = th;
  s.rx[nout] = tw;
  for (int l = nout - 1; l >= 0; --l) {
    s.ry[l] = 2 * s.ry[l + 1] + 3;
    s.rx[l] = 2 * s.rx[l + 1] + 3;
  }
  // the level buffer holds the source's region (the largest); mid the y
  // pass of level 1, the largest of the mids
  s.mid_off = (s.ry[0] * s.rx[0] + 3) / 4 * 4;
  s.floats = s.mid_off + s.ry[1] * s.rx[0];
  return s;
}

int pyr_smem_max() {
  int most = 0;
  for (const auto& t : kPyrTiles) {
    const PyrShape s = pyr_shape(kMaxOut, t[1], t[0]);
    most = max(most, s.floats * static_cast<int>(sizeof(float)));
  }
  return most;
}

// ---------------------------------------------------------- Scharr ---

constexpr int kScTW = 64, kScTH = 16;
constexpr int kScIH = kScTH + 2;              // a row of halo each way
constexpr int kScIW = kScTW + 2 * kHalo;      // 4 columns: float4 rows

struct ScharrParams {
  const float* in;
  float* gx;
  float* gy;
  int H, W;
  int vec;
};

// [3 10 3] / 16 at offsets -1, 0, 1; [-1 0 1] / 2's non-zero taps at -1, 1
__device__ __forceinline__ float smooth3(const float* src, int step) {
  float acc = 0.0f;
  acc = __fadd_rn(acc, __fmul_rn(0.1875f, src[-step]));
  acc = __fadd_rn(acc, __fmul_rn(0.625f, src[0]));
  acc = __fadd_rn(acc, __fmul_rn(0.1875f, src[step]));
  return acc;
}

__device__ __forceinline__ float diff2(const float* src, int step) {
  float acc = 0.0f;
  acc = __fadd_rn(acc, __fmul_rn(-0.5f, src[-step]));
  acc = __fadd_rn(acc, __fmul_rn(0.5f, src[step]));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
scharr_kernel(const __grid_constant__ ScharrParams p) {
  __shared__ __align__(16) float in[kScIH * kScIW];
  __shared__ float sy[kScTH * kScIW];   // y-smoothed at the tile's rows
  __shared__ float sx[kScIH * kScTW];   // x-smoothed at the tile's columns
  const int oy0 = blockIdx.y * kScTH, ox0 = blockIdx.x * kScTW;
  load_region<kScIH, kScIW>(in, p.in, p.H, p.W, oy0 - 1, ox0 - kHalo,
                            p.vec != 0);
  __syncthreads();
  for (int i = threadIdx.x; i < kScTH * kScIW; i += kThreads) {
    const int ty = i / kScIW, c = i % kScIW;
    sy[i] = smooth3(&in[(ty + 1) * kScIW + c], kScIW);
  }
  for (int i = threadIdx.x; i < kScIH * kScTW; i += kThreads) {
    const int r = i / kScTW, tx = i % kScTW;
    sx[i] = smooth3(&in[r * kScIW + tx + kHalo], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kScTH * kScTW; i += kThreads) {
    const int ty = i / kScTW, tx = i % kScTW;
    const int oy = oy0 + ty, ox = ox0 + tx;
    if (oy < p.H && ox < p.W) {
      const int64_t o = static_cast<int64_t>(oy) * p.W + ox;
      p.gx[o] = diff2(&sy[ty * kScIW + tx + kHalo], 1);
      p.gy[o] = diff2(&sx[(ty + 1) * kScTW + tx], kScTW);
    }
  }
}

}  // namespace

// Sets what the kernels need before their first launch (the pyramid's
// dynamic shared memory above 48 KB); called once when the library is
// loaded. Returns the CUDA error code (0: none).
extern "C" int separable_filter_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pyr_smem_max()));
}

// Launches the one-image kernel on `stream`; returns the CUDA error code
// (0: none), -1 for arguments it does not take. `in` is an (H, W) f32
// image, `out` (ceil(H / stride), ceil(W / stride)); offy/wy and offx/wx
// are host arrays of ny and nx non-zero taps (offsets in [-4, 4], tap
// order).
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
  p.Ho = (H + stride - 1) / stride;
  p.Wo = (W + stride - 1) / stride;
  p.x_first = x_first;
  p.vec = aligned_rows(in, W);
  const int tw = stride == 1 ? Tile<1>::W : Tile<2>::W;
  const int th = stride == 1 ? Tile<1>::H : Tile<2>::H;
  const dim3 grid((p.Wo + tw - 1) / tw, (p.Ho + th - 1) / th);
  pick_filter(stride, ny, nx)<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launches the pyramid kernel on `stream`: `nout` (1 to 3) levels below
// the (H, W) f32 source `in`, each pyr_down of the one above, into `out1`
// .. `out3` (ceil halves of the level above; the unused ones null).
// Returns the CUDA error code (0: none), -1 for arguments it does not
// take.
extern "C" int separable_pyramid_launch(const void* in, int H, int W,
                                        int nout, void* out1, void* out2,
                                        void* out3, void* stream) {
  if (H < 1 || W < 1 || nout < 1 || nout > kMaxOut) return -1;
  PyrParams p{};
  p.in = static_cast<const float*>(in);
  void* outs[kMaxOut] = {out1, out2, out3};
  p.H[0] = H;
  p.W[0] = W;
  for (int l = 1; l <= nout; ++l) {
    if (outs[l - 1] == nullptr) return -1;
    p.out[l - 1] = static_cast<float*>(outs[l - 1]);
    p.H[l] = (p.H[l - 1] + 1) / 2;
    p.W[l] = (p.W[l - 1] + 1) / 2;
  }
  p.nout = nout;
  const int Hn = p.H[nout], Wn = p.W[nout];
  const auto* tile = &kPyrTiles[3];
  for (const auto& t : kPyrTiles) {
    if (((Wn + t[0] - 1) / t[0]) * ((Hn + t[1] - 1) / t[1]) >= kFillCtas) {
      tile = &t;
      break;
    }
  }
  const PyrShape s = pyr_shape(nout, (*tile)[1], (*tile)[0]);
  p.th = s.th;
  p.tw = s.tw;
  for (int l = 0; l <= nout; ++l) {
    p.ry[l] = s.ry[l];
    p.rx[l] = s.rx[l];
  }
  p.mid_off = s.mid_off;
  const dim3 grid((Wn + s.tw - 1) / s.tw, (Hn + s.th - 1) / s.th);
  pyramid_kernel<<<grid, kPyrThreads, s.floats * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launches the Scharr kernel on `stream`: both gradients of the (H, W)
// f32 image `in` into `gx` and `gy` (H, W). Returns the CUDA error code
// (0: none), -1 for arguments it does not take.
extern "C" int separable_scharr_launch(const void* in, int H, int W,
                                       void* gx, void* gy, void* stream) {
  if (H < 1 || W < 1) return -1;
  ScharrParams p{};
  p.in = static_cast<const float*>(in);
  p.gx = static_cast<float*>(gx);
  p.gy = static_cast<float*>(gy);
  p.H = H;
  p.W = W;
  p.vec = aligned_rows(in, W);
  const dim3 grid((W + kScTW - 1) / kScTW, (H + kScTH - 1) / kScTH);
  scharr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
