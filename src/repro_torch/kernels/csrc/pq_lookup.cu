// PQ distance lookup, Eq. (3): dist = sum_m ADT[m, code[m]].
//
// Replaces the Pallas kernel src/repro/kernels/pq_lookup.py::pq_lookup.  The
// TPU kernel rewrites the lookup as a one-hot MXU product because a TPU has no
// fast gather; Hopper has one, so this is a plain gather.
//
// Design: one warp per scored row, 8 rows per 256-thread block.  Lane m reads
// byte m of the row's code (for M = 32 one coalesced 32-byte sector; M > 32
// loops in strides of 32, M < 32 leaves the spare lanes idle), then
// ADT[m, code] through the read-only path, and the warp sums its lanes with
// __shfl_xor_sync.  Nothing is staged in shared memory: a round's (Q, M, C)
// tables (8.4 MB at Q=256, M=32, C=256) stay in the 50 MB L2, and a row reads
// only its M entries of them.
//
// Summation order: lane m adds entries m, m+32, ... in turn, then the warp adds
// the 32 partial sums as a butterfly tree; the plain version adds left to
// right.  The two differ by rounding, so the tests hold the kernel to
// rtol/atol 1e-4.
//
// Two entry points:
//   pq_lookup_launch         (N, M) u8 codes, one (M, C) ADT -> (N,)
//                            (the reference signature, kept for parity);
//   pq_lookup_gather_launch  (Q, n) i32 ids, (N_base, M) u8 code table,
//                            (Q, M, C) ADTs, an optional (Q, n) bool mask ->
//                            (Q, n).  A pair whose mask is false reads no code
//                            and no ADT entry and gets +inf.  The search uses
//                            this one, with its "fresh" mask.
// Bound: bytes — per scored row its id, its M code bytes and M ADT entries —
// and, at a round's small Q*n, the latency of the dependent id -> code -> ADT
// loads, which the one-warp-per-row layout keeps to three.
// An id outside [0, N_base), masked or not, or a code >= C traps: a raw
// pointer does not wrap, and a wild read would return a silently wrong
// distance.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;   // warps of a 256-thread block

__device__ __forceinline__ float warp_lookup(const float* __restrict__ adt,
                                             const uint8_t* __restrict__ row,
                                             int M, int C, int lane) {
  float acc = 0.f;
  for (int m = lane; m < M; m += 32) {
    const int code = __ldg(row + m);
    if (code >= C) __trap();
    acc += __ldg(adt + m * C + code);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  return acc;
}

__global__ void pq_lookup_kernel(const uint8_t* __restrict__ codes,
                                 const float* __restrict__ adt,
                                 float* __restrict__ out,
                                 int N, int M, int C) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kRowsPerBlock;
  // n is the same for the whole warp, so every lane reaches the shuffles
  for (int n = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5); n < N;
       n += stride) {
    const float d = warp_lookup(adt, codes + (size_t)n * M, M, C, lane);
    if (lane == 0) out[n] = d;
  }
}

__global__ void pq_lookup_gather_kernel(const int32_t* __restrict__ ids,
                                        const uint8_t* __restrict__ mask,
                                        const uint8_t* __restrict__ codes,
                                        const float* __restrict__ adts,
                                        float* __restrict__ out,
                                        int Q, int n, int N, int M, int C) {
  const size_t pair = (size_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (pair >= (size_t)Q * n) return;
  const int lane = threadIdx.x & 31;
  const int id = __ldg(ids + pair);
  if (id < 0 || id >= N) __trap();
  if (mask != nullptr && !__ldg(mask + pair)) {
    if (lane == 0) out[pair] = INFINITY;
    return;
  }
  const size_t q = pair / n;
  const float d = warp_lookup(adts + q * M * C, codes + (size_t)id * M, M, C,
                              lane);
  if (lane == 0) out[pair] = d;
}

}  // namespace

extern "C" int pq_lookup_launch(const void* codes, const void* adt, void* out,
                                int N, int M, int C, void* stream) {
  if (N == 0) return 0;
  const int need = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const int blocks = need < 65536 ? need : 65536;
  pq_lookup_kernel<<<blocks, 32 * kRowsPerBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(adt),
      static_cast<float*>(out), N, M, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pq_lookup_gather_launch(const void* ids, const void* mask,
                                       const void* codes, const void* adts,
                                       void* out, int Q, int n, int N, int M,
                                       int C, void* stream) {
  if (Q == 0 || n == 0) return 0;
  const size_t pairs = (size_t)Q * n;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kRowsPerBlock - 1) / kRowsPerBlock);
  pq_lookup_gather_kernel<<<blocks, 32 * kRowsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const uint8_t*>(mask),
      static_cast<const uint8_t*>(codes), static_cast<const float*>(adts),
      static_cast<float*>(out), Q, n, N, M, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
