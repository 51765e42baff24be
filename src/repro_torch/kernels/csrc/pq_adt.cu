// Asymmetric distance tables: (Q, M*dsub) queries x (M, C, dsub) codebook
// -> (Q, M, C).  l2: sum_d (q - c)^2; ip/angular: -sum_d q*c.
//
// Replaces the Pallas kernel src/repro/kernels/pq_adt.py::pq_adt.  Direct
// form, like the TPU kernel.  One block per (query, block of MB subspaces);
// the block's MB*dsub query values sit in shared memory and each thread owns
// centroids c = tid, tid + blockDim.x, ...  Bound: the (Q, M, C) output write
// (8.4 MB at Q=256, M=32, C=256); the codebook (128 KB) stays in L2.
#include <cuda_runtime.h>

namespace {

constexpr int kSubspacesPerBlock = 8;

template <bool kL2>
__global__ void pq_adt_kernel(const float* __restrict__ queries,
                              const float* __restrict__ cents,
                              float* __restrict__ out,
                              int M, int C, int dsub) {
  extern __shared__ float qs[];
  const int q = blockIdx.x;
  const int m0 = blockIdx.y * kSubspacesPerBlock;
  const int m1 = min(m0 + kSubspacesPerBlock, M);
  const float* qrow = queries + (size_t)q * M * dsub + (size_t)m0 * dsub;
  for (int i = threadIdx.x; i < (m1 - m0) * dsub; i += blockDim.x) {
    qs[i] = qrow[i];
  }
  __syncthreads();
  for (int m = m0; m < m1; ++m) {
    const float* qv = qs + (m - m0) * dsub;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float* cv = cents + ((size_t)m * C + c) * dsub;
      float acc = 0.f;
      for (int d = 0; d < dsub; ++d) {
        if (kL2) {
          const float diff = qv[d] - cv[d];
          acc += diff * diff;
        } else {
          acc += qv[d] * cv[d];
        }
      }
      out[((size_t)q * M + m) * C + c] = kL2 ? acc : -acc;
    }
  }
}

}  // namespace

extern "C" int pq_adt_launch(const void* queries, const void* cents, void* out,
                             int Q, int M, int C, int dsub, int l2,
                             void* stream) {
  if (Q == 0) return 0;
  dim3 grid(Q, (M + kSubspacesPerBlock - 1) / kSubspacesPerBlock);
  const int threads = C < 256 ? ((C + 31) / 32) * 32 : 256;
  const size_t smem = sizeof(float) * kSubspacesPerBlock * dsub;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l2) {
    pq_adt_kernel<true><<<grid, threads, smem, s>>>(
        static_cast<const float*>(queries), static_cast<const float*>(cents),
        static_cast<float*>(out), M, C, dsub);
  } else {
    pq_adt_kernel<false><<<grid, threads, smem, s>>>(
        static_cast<const float*>(queries), static_cast<const float*>(cents),
        static_cast<float*>(out), M, C, dsub);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
