// Exact distances for the beta-margin rerank: l2 ||q||^2 - 2 q.x + ||x||^2,
// ip/angular -q.x.
//
// Replaces the Pallas kernel src/repro/kernels/l2_rerank.py::l2_rerank.  One
// warp per (query, candidate): each lane strides over D accumulating q.x,
// q.q and x.x, then a shuffle reduction.  Two entry points:
//   l2_rerank_launch         (Q, D) queries, (Q, K, D) gathered rows -> (Q, K)
//                            (the reference signature, kept for parity);
//   l2_rerank_gather_launch  (Q, D) queries, (Q, K) i32 ids, (N, D) base
//                            -> (Q, K): the rows are gathered inside the
//                            kernel, so the (Q, K, D) copy is never written.
//                            The search uses this one.
// Bound: reading the Q*K candidate rows (16.8 MB at Q=256, K=128, D=128).
// An id outside [0, N) traps instead of reading a wild row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kL2, bool kGather>
__global__ void l2_rerank_kernel(const float* __restrict__ queries,
                                 const float* __restrict__ rows,
                                 const int32_t* __restrict__ ids,
                                 float* __restrict__ out,
                                 int Q, int K, int D, int N) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(Q) * K) return;   // whole warp leaves
  const int q = static_cast<int>(warp / K);
  const float* qv = queries + static_cast<size_t>(q) * D;
  const float* xv;
  if (kGather) {
    const int id = ids[warp];
    if (id < 0 || id >= N) __trap();
    xv = rows + static_cast<size_t>(id) * D;
  } else {
    xv = rows + static_cast<size_t>(warp) * D;
  }
  float dot = 0.f, qq = 0.f, xx = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float a = qv[d], b = xv[d];
    dot += a * b;
    if (kL2) { qq += a * a; xx += b * b; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (kL2) {
      qq += __shfl_xor_sync(0xffffffffu, qq, off);
      xx += __shfl_xor_sync(0xffffffffu, xx, off);
    }
  }
  if (lane == 0) out[warp] = kL2 ? (qq - 2.f * dot) + xx : -dot;
}

template <bool kGather>
int launch(const void* queries, const void* rows, const void* ids, void* out,
           int Q, int K, int D, int N, int l2, void* stream) {
  if (Q == 0 || K == 0) return 0;
  const int threads = 256;
  const long long warps = static_cast<long long>(Q) * K;
  const int blocks = static_cast<int>((warps * 32 + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(queries);
  const float* rp = static_cast<const float*>(rows);
  const int32_t* ip = static_cast<const int32_t*>(ids);
  float* op = static_cast<float*>(out);
  if (l2) {
    l2_rerank_kernel<true, kGather><<<blocks, threads, 0, s>>>(qp, rp, ip, op,
                                                              Q, K, D, N);
  } else {
    l2_rerank_kernel<false, kGather><<<blocks, threads, 0, s>>>(qp, rp, ip, op,
                                                               Q, K, D, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int l2_rerank_launch(const void* queries, const void* cands,
                                void* out, int Q, int K, int D, int l2,
                                void* stream) {
  return launch<false>(queries, cands, nullptr, out, Q, K, D, 0, l2, stream);
}

extern "C" int l2_rerank_gather_launch(const void* queries, const void* ids,
                                       const void* base, void* out, int Q,
                                       int K, int D, int N, int l2,
                                       void* stream) {
  return launch<true>(queries, base, ids, out, Q, K, D, N, l2, stream);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
