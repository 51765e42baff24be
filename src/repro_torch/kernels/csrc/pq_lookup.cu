// PQ distance lookup, Eq. (3): dist = sum_m ADT[m, code[m]].
//
// Replaces the Pallas kernel src/repro/kernels/pq_lookup.py::pq_lookup.  The
// TPU kernel rewrites the lookup as a one-hot MXU product because a TPU has no
// fast gather; Hopper has one, so this is a plain gather from an ADT staged in
// shared memory (M*C*4 bytes: 32 KB at M=32, C=256).
//
// Two entry points:
//   pq_lookup_launch         (N, M) u8 codes, one (M, C) ADT -> (N,)
//                            (the reference signature, kept for parity);
//   pq_lookup_gather_launch  (Q, n) i32 ids, (N_base, M) u8 code table,
//                            (Q, M, C) ADTs -> (Q, n): one block per query
//                            lane, gathering its candidates' code rows.  The
//                            search uses this one.
// Bound: staging the lane's ADT — every launch re-reads the whole (Q, M, C)
// table (8.4 MB at Q=256) to score Q*n candidates (64 each at E=1, R=64).
// An id outside [0, N_base) or a code >= C traps: a raw pointer does not
// wrap, and a wild read would return a silently wrong distance.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void stage_adt(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

__device__ __forceinline__ float lookup_row(const float* adt,
                                            const uint8_t* row, int M, int C) {
  float acc = 0.f;
  for (int m = 0; m < M; ++m) {
    const int code = row[m];
    if (code >= C) __trap();
    acc += adt[m * C + code];
  }
  return acc;
}

__global__ void pq_lookup_kernel(const uint8_t* __restrict__ codes,
                                 const float* __restrict__ adt,
                                 float* __restrict__ out,
                                 int N, int M, int C) {
  extern __shared__ float s_adt[];
  stage_adt(s_adt, adt, M * C);
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    out[n] = lookup_row(s_adt, codes + (size_t)n * M, M, C);
  }
}

__global__ void pq_lookup_gather_kernel(const int32_t* __restrict__ ids,
                                        const uint8_t* __restrict__ codes,
                                        const float* __restrict__ adts,
                                        float* __restrict__ out,
                                        int n, int N, int M, int C) {
  extern __shared__ float s_adt[];
  const int q = blockIdx.x;
  stage_adt(s_adt, adts + (size_t)q * M * C, M * C);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int id = ids[(size_t)q * n + j];
    if (id < 0 || id >= N) __trap();
    out[(size_t)q * n + j] = lookup_row(s_adt, codes + (size_t)id * M, M, C);
  }
}

int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

extern "C" int pq_lookup_launch(const void* codes, const void* adt, void* out,
                                int N, int M, int C, void* stream) {
  if (N == 0) return 0;
  const size_t smem = sizeof(float) * M * C;
  int err = set_smem(reinterpret_cast<const void*>(pq_lookup_kernel), smem);
  if (err) return err;
  const int threads = 256;
  const int blocks = (N + threads - 1) / threads < 1024
                         ? (N + threads - 1) / threads : 1024;
  pq_lookup_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(adt),
      static_cast<float*>(out), N, M, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pq_lookup_gather_launch(const void* ids, const void* codes,
                                       const void* adts, void* out,
                                       int Q, int n, int N, int M, int C,
                                       void* stream) {
  if (Q == 0 || n == 0) return 0;
  const size_t smem = sizeof(float) * M * C;
  int err = set_smem(reinterpret_cast<const void*>(pq_lookup_gather_kernel),
                     smem);
  if (err) return err;
  pq_lookup_gather_kernel<<<Q, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(adts), static_cast<float*>(out), n, N, M, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
