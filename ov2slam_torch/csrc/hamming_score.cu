// Place-index scoring on Hopper's int8 tensor cores.
//
// Replaces ov2slam_tpu/ops/pallas_hamming.py::_score_kernel (launched by
// match_scores_bits). For every stored keyframe m:
//
//   score[m] = #{ valid query rows q : max over valid stored rows k of m
//                 of <q, k> >= 256 - 2 * match_bits } / max(#valid q, 1)
//
// where rows are BRIEF-256 descriptors unpacked to int8 ±1 (0 for invalid
// rows). Ham(a, b) = (256 - <a, b>) / 2, so the test is Ham <= match_bits.
// Every partial sum is an integer of magnitude <= 256: int8 products with
// int32 accumulation are exact, and the one division is IEEE f32
// (__fdiv_rn), so the result equals both plain versions bit for bit.
// Never build this file with --use_fast_math.
//
// Bound on an H100 SXM: 2 * 256 operations per (valid query, valid stored
// row) pair at the int8 tensor-core rate (1979 TOP/s); the bytes floor is
// the ±1 cube, M * N * (256 + 1) bytes, at 3.35 TB/s. At M = 2048,
// N = Nq = 1024 the operations set it (~0.45 ms). A popcount kernel cannot
// reach it: 8 POPC per pair saturate the integer pipe at ~9x the bound.
//
// Design. The query side is the wgmma A operand (64-row tiles), the stored
// rows are B (128-row tiles, N of the MMA), K = 256 in 8 steps of 32.
//  - A CTA owns one query tile of 128 rows, loaded once by TMA and kept in
//    shared memory, and walks a contiguous range of keyframes; the stored
//    rows stream through a ring of two stages, each loaded by TMA
//    (128-byte swizzle, two 128-byte K halves per tile) on an mbarrier by
//    one producer warp. The producer's other lanes write the tile's column
//    biases (0 for a valid stored row, -65536 for an invalid or missing
//    one) beside it.
//  - Two consumer warpgroups run wgmma m64n128k32 s32.s8.s8 on their half
//    of the query tile, add the biases and fold the tile into a running
//    per-row max in registers: no (Nq, N) array leaves the SM. After a
//    keyframe's last tile the max is reduced across the quad of lanes that
//    share a row, thresholded, counted with ballots, and added to
//    per-keyframe int32 counters; the last CTA of a keyframe (a ticket)
//    divides.
//  - The grid is (query tiles x keyframe chunks), sized to one wave of two
//    CTAs per SM, so a few keyframes (the main path scores only the
//    populated prefix) still occupy every SM.
//
// What holds it back: the MMAs. The kernel multiplies every pair, invalid
// rows included, while the bound counts valid pairs only; the fold adds
// the rest (ptxas fuses it into DPX add-max instructions).

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kK = 256;              // int8 columns per descriptor
constexpr int kHalf = 128;           // bytes in one swizzled K half
constexpr int kNT = 128;             // stored rows per tile (MMA N)
constexpr int kConsumers = 2;        // consumer warpgroups
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kBias = -65536;        // added to invalid stored columns
constexpr int kNone = 2 * kBias;     // running max before any column

constexpr int kMT = 1;               // 64-row m-tiles per warpgroup
constexpr int kStages = 2;           // stored-tile ring
constexpr int kMinBlocks = 2;        // CTAs per SM

struct Layout {
  static constexpr int rows = kConsumers * kMT * 64;   // query rows per CTA
  static constexpr int a_bytes = rows * kK;
  static constexpr int b_bytes = kNT * kK;             // one stage
  static constexpr int bias_off = a_bytes + kStages * b_bytes;
  static constexpr int bar_off = bias_off + kStages * kNT * 4;
  // + 1024 so the base can be rounded up to the swizzle atom
  static constexpr int smem = bar_off + (2 * kStages + 1) * 8 + 1024;
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
score_kernel(const __grid_constant__ CUtensorMap store_map,
             const __grid_constant__ CUtensorMap query_map,
             const uint8_t* __restrict__ store_valid,
             const uint8_t* __restrict__ query_valid,
             int M, int N, int Nq, int n_qtiles, int n_chunks, int th,
             int* __restrict__ counts, float* __restrict__ out) {
  using L = Layout;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023))
                              & 1023);
  uint8_t* sA = base;
  uint8_t* sB = base + L::a_bytes;
  int32_t* sBias = reinterpret_cast<int32_t*>(base + L::bias_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::bar_off);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int qt = blockIdx.x % n_qtiles;
  const int chunk = blockIdx.x / n_qtiles;
  const int m_begin = static_cast<int>(static_cast<long long>(chunk) * M
                                       / n_chunks);
  const int m_end = static_cast<int>(static_cast<long long>(chunk + 1) * M
                                     / n_chunks);
  const int q0 = qt * L::rows;
  const int tiles_per_kf = (N + kNT - 1) / kNT;
  const int n_tiles = (m_end - m_begin) * tiles_per_kf;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 33);   // TMA bytes + 32 bias writers
      hopper::mbar_init(&empty[s], kConsumers * 4);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // ---- producer warp: TMA for lane 0, column biases for every lane
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(qbar, L::a_bytes);
      hopper::tma_load_2d(sA, &query_map, qbar, 0, q0);
      hopper::tma_load_2d(sA + L::rows * kHalf, &query_map, qbar, kHalf, q0);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int m = m_begin + t / tiles_per_kf;
      const int n = (t % tiles_per_kf) * kNT + lane * 4;
      const uint8_t* v = store_valid + static_cast<size_t>(m) * N;
      uint8_t f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = (n + j < N) ? v[n + j] : 0;
      if (t >= kStages) hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
      if (lane == 0) {
        uint8_t* dst = sB + s * L::b_bytes;
        const int n0 = n;   // lane 0's first column is the tile's
        hopper::mbar_arrive_expect_tx(&full[s], L::b_bytes);
        hopper::tma_load_3d(dst, &store_map, &full[s], 0, n0, m);
        hopper::tma_load_3d(dst + kNT * kHalf, &store_map, &full[s], kHalf,
                            n0, m);
      }
      const int4 b = make_int4(f[0] ? 0 : kBias, f[1] ? 0 : kBias,
                               f[2] ? 0 : kBias, f[3] ? 0 : kBias);
      reinterpret_cast<int4*>(sBias + s * kNT)[lane] = b;
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroups
  const int wg = warp / 4;
  const int wq = warp % 4;
  const int quad = lane & 3;
  bool row_valid[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + (wg * kMT + mt) * 64 + wq * 16 + lane / 4 + 8 * i;
      row_valid[mt][i] = quad == 0 && row < Nq && query_valid[row] != 0;
    }
  }
  int32_t acc[kMT][64];
  int best[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) best[mt][0] = best[mt][1] = kNone;

  const uint32_t a_base = hopper::smem_addr(sA) + wg * kMT * 64 * kHalf;
  hopper::mbar_wait(qbar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const uint32_t b_base = hopper::smem_addr(sB + s * L::b_bytes);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) hopper::fence_regs(acc[mt]);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kK / 32; ++k) {
      const uint32_t koff = (k % 4) * 32;
      const uint64_t db = hopper::desc_k_sw128(
          b_base + (k / 4) * kNT * kHalf + koff);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const uint64_t da = hopper::desc_k_sw128(
            a_base + (k / 4) * L::rows * kHalf + mt * 64 * kHalf + koff);
        hopper::wgmma_m64n128k32_s8(acc[mt], da, db, k > 0);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) hopper::fence_regs(acc[mt]);

    // fold the tile into the running per-row max; this thread's columns
    // are 8c + 2 * quad + {0, 1}
    const int2* bias2 = reinterpret_cast<const int2*>(sBias + s * kNT) + quad;
#pragma unroll
    for (int c = 0; c < kNT / 8; ++c) {
      const int2 b = bias2[4 * c];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          best[mt][i] = max(best[mt][i],
                            max(acc[mt][4 * c + 2 * i] + b.x,
                                acc[mt][4 * c + 2 * i + 1] + b.y));
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);

    if ((t + 1) % tiles_per_kf != 0) continue;
    // ---- keyframe m done: per-row max across the quad, count, publish
    const int m = m_begin + t / tiles_per_kf;
    int hits = 0;
    int nval = 0;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int b = best[mt][i];
        b = max(b, __shfl_xor_sync(0xffffffffu, b, 1));
        b = max(b, __shfl_xor_sync(0xffffffffu, b, 2));
        hits += __popc(__ballot_sync(0xffffffffu,
                                     row_valid[mt][i] && b >= th));
        nval += __popc(__ballot_sync(0xffffffffu, row_valid[mt][i]));
        best[mt][i] = kNone;
      }
    }
    if (lane == 0) {
      if (hits) atomicAdd(&counts[m], hits);
      if (nval) atomicAdd(&counts[M + m], nval);
      __threadfence();
    }
    hopper::named_barrier(1, kConsumers * 128);
    if (threadIdx.x == 0) {
      const int ticket = atomicAdd(&counts[2 * M + m], 1);
      if (ticket == n_qtiles - 1) {   // every query tile has counted m
        __threadfence();
        const int h = atomicAdd(&counts[m], 0);
        const int nv = atomicAdd(&counts[M + m], 0);
        out[m] = __fdiv_rn(static_cast<float>(h),
                           static_cast<float>(nv > 1 ? nv : 1));
      }
    }
  }
}

}  // namespace

// Launches on ``stream``; returns 0, a cudaError_t, or one of the
// tensor-map codes of hopper.cuh. Device pointers: store (M, N, 256) int8
// ±1, store_valid (M, N) bytes, query (Nq, 256) int8 ±1, query_valid (Nq,)
// bytes, counts (3, M) int32 zeroed by the caller, out (M,) floats. The
// store and query must be 16-byte aligned; M, N, Nq >= 1.
extern "C" int hamming_score_launch(const void* store, const void* store_valid,
                                    const void* query, const void* query_valid,
                                    int M, int N, int Nq, int match_bits,
                                    void* counts, void* out, void* stream) {
  if (M <= 0 || N <= 0 || Nq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  using L = Layout;
  CUtensorMap store_map, query_map;
  {
    const cuuint64_t dims[3] = {kK, static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[2] = {kK, static_cast<cuuint64_t>(N) * kK};
    const cuuint32_t box[3] = {kHalf, kNT, 1};
    const int e = hopper::encode_u8_sw128(&store_map, store, 3, dims,
                                          strides, box);
    if (e) return e;
  }
  {
    const cuuint64_t dims[2] = {kK, static_cast<cuuint64_t>(Nq)};
    const cuuint64_t strides[1] = {kK};
    const cuuint32_t box[2] = {kHalf, static_cast<cuuint32_t>(L::rows)};
    const int e = hopper::encode_u8_sw128(&query_map, query, 2, dims,
                                          strides, box);
    if (e) return e;
  }
  cudaError_t e = cudaFuncSetAttribute(
      score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qtiles = (Nq + L::rows - 1) / L::rows;
  // one wave of CTAs: each walks a contiguous chunk of >= 1 keyframes
  int n_chunks = sms * kMinBlocks / n_qtiles;
  n_chunks = n_chunks < 1 ? 1 : (n_chunks > M ? M : n_chunks);
  score_kernel<<<n_qtiles * n_chunks, kThreads, L::smem,
                 static_cast<cudaStream_t>(stream)>>>(
      store_map, query_map, static_cast<const uint8_t*>(store_valid),
      static_cast<const uint8_t*>(query_valid), M, N, Nq, n_qtiles,
      n_chunks, 256 - 2 * match_bits, static_cast<int*>(counts),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

