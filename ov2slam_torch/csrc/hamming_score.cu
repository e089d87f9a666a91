// Place-index scoring: BRIEF-256 Hamming match fractions per stored keyframe.
//
// Replaces ov2slam_tpu/ops/pallas_hamming.py::_score_kernel (launched by
// match_scores_bits). For every stored keyframe m:
//
//   score[m] = #{ valid query rows q : min over valid stored rows k of m
//                 of Hamming(q, k) <= match_bits } / max(#valid queries, 1)
//
// Design (first Hopper version, simple and exact): one CTA per stored
// keyframe. The keyframe's N x 8 packed words and its valid flags are staged
// in shared memory (24 KB at N = 768); each thread takes query rows with a
// block stride, keeps the query's 8 words in registers, and walks the staged
// rows with XOR + __popc (every thread of a warp reads the same staged row,
// a shared-memory broadcast). Invalid stored rows are skipped, which is the
// same as scoring them 257. Hits are reduced across the block with warp
// shuffles; the one division is IEEE f32 (__fdiv_rn), as in both JAX paths,
// so the result is bit-exact. Never build this file with --use_fast_math.
//
// Bound on an H100 SXM: P = M*N*Nq descriptor pairs. Memory floor: the
// store's M*N*33 bytes at 3.35 TB/s. Compute floor: the exact ±1 int8
// tensor-core formulation, 2*P*256 ops at 1979 TOP/s. At M = 2048,
// N = Nq = 768 that is ~0.31 ms and compute sets it. This popcount kernel
// runs on the integer pipes (POPC has a fraction of the ALU rate), so it is
// several times above that bound; a wgmma int8 (±1) GEMM with a fused
// per-query max epilogue is the later work that approaches it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hamming_score_kernel(const uint32_t* __restrict__ store,
                     const uint8_t* __restrict__ store_valid,
                     const uint32_t* __restrict__ query,
                     const uint8_t* __restrict__ query_valid,
                     int N, int Nq, int match_bits,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* rows = reinterpret_cast<uint4*>(smem);                // N * 2
  uint8_t* kvalid = smem + static_cast<size_t>(N) * kWords * 4;  // N

  const int m = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(
      store + static_cast<size_t>(m) * N * kWords);
  for (int i = threadIdx.x; i < N * 2; i += blockDim.x) rows[i] = src[i];
  const uint8_t* vsrc = store_valid + static_cast<size_t>(m) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) kvalid[i] = vsrc[i];
  __syncthreads();

  int hits = 0;
  int nq_valid = 0;
  for (int qi = threadIdx.x; qi < Nq; qi += blockDim.x) {
    if (!query_valid[qi]) continue;
    ++nq_valid;
    const uint4* qp = reinterpret_cast<const uint4*>(query) + 2 * qi;
    const uint4 qa = qp[0];
    const uint4 qb = qp[1];
    int best = 257;
    for (int k = 0; k < N; ++k) {
      if (!kvalid[k]) continue;
      const uint4 ka = rows[2 * k];
      const uint4 kb = rows[2 * k + 1];
      const int d = __popc(qa.x ^ ka.x) + __popc(qa.y ^ ka.y) +
                    __popc(qa.z ^ ka.z) + __popc(qa.w ^ ka.w) +
                    __popc(qb.x ^ kb.x) + __popc(qb.y ^ kb.y) +
                    __popc(qb.z ^ kb.z) + __popc(qb.w ^ kb.w);
      best = min(best, d);
    }
    hits += (best <= match_bits) ? 1 : 0;
  }

  // block reduction of (hits, nq_valid)
  for (int off = 16; off > 0; off >>= 1) {
    hits += __shfl_down_sync(0xffffffffu, hits, off);
    nq_valid += __shfl_down_sync(0xffffffffu, nq_valid, off);
  }
  __shared__ int red[2][kThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = hits;
    red[1][warp] = nq_valid;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int h = 0, n = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      h += red[0][w];
      n += red[1][w];
    }
    out[m] = __fdiv_rn(static_cast<float>(h),
                       static_cast<float>(n > 1 ? n : 1));
  }
}

}  // namespace

// Launches on ``stream``; returns the cudaError_t of the launch (0 = ok).
// Pointers are device pointers: store (M, N, 8) words, store_valid (M, N)
// bytes, query (Nq, 8) words, query_valid (Nq,) bytes, out (M,) floats.
// The store and query must be 16-byte aligned.
extern "C" int hamming_score_launch(const void* store, const void* store_valid,
                                    const void* query, const void* query_valid,
                                    int M, int N, int Nq, int match_bits,
                                    void* out, void* stream) {
  if (M <= 0) return 0;
  const size_t smem = static_cast<size_t>(N) * kWords * 4 + N;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hamming_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hamming_score_kernel<<<M, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(store),
      static_cast<const uint8_t*>(store_valid),
      static_cast<const uint32_t*>(query),
      static_cast<const uint8_t*>(query_valid), N, Nq, match_bits,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
