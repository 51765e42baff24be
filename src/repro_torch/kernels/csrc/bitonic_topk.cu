// Row-wise ascending sort of (Q, P) float keys carrying an int32 payload,
// P a power of two.
//
// Replaces the Pallas kernel src/repro/kernels/bitonic_topk.py::
// bitonic_sort_pairs (the paper's shared Bitonic Sorter).  One block per row;
// the row's keys and original positions sit in shared memory and the whole
// network runs there.  Unlike the TPU network, elements compare on
// (key, original position), a total order, so the result is the stable sort:
// ties come out in input order, exactly like torch.sort(stable=True) and the
// reference's jnp.argsort(stable=True).  Keys must not be NaN.
// Bound: latency of log2(P)*(log2(P)+1)/2 barrier-separated stages per row;
// the bytes (Q*P*16 in and out) are tiny.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bitonic_sort_kernel(const float* __restrict__ keys,
                                    const int32_t* __restrict__ vals,
                                    float* __restrict__ out_keys,
                                    int32_t* __restrict__ out_vals, int P) {
  extern __shared__ unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  int32_t* sp = reinterpret_cast<int32_t*>(sk + P);
  const size_t row = static_cast<size_t>(blockIdx.x) * P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    sk[i] = keys[row + i];
    sp[i] = i;
  }
  __syncthreads();
  const int half = P >> 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int lo = (t / j) * 2 * j + (t % j);
        const int hi = lo + j;
        const bool ascending = (lo & k) == 0;
        const float a = sk[lo], b = sk[hi];
        const int32_t pa = sp[lo], pb = sp[hi];
        const bool a_after_b = (a > b) || (a == b && pa > pb);
        if (a_after_b == ascending) {
          sk[lo] = b; sk[hi] = a;
          sp[lo] = pb; sp[hi] = pa;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    out_keys[row + i] = sk[i];
    out_vals[row + i] = vals[row + sp[i]];
  }
}

}  // namespace

extern "C" int bitonic_sort_launch(const void* keys, const void* vals,
                                   void* out_keys, void* out_vals, int Q, int P,
                                   void* stream) {
  if (Q == 0) return 0;
  const size_t smem = static_cast<size_t>(P) * (sizeof(float) + sizeof(int32_t));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bitonic_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = P / 2 < 1024 ? (P / 2 < 32 ? 32 : P / 2) : 1024;
  bitonic_sort_kernel<<<Q, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keys), static_cast<const int32_t*>(vals),
      static_cast<float*>(out_keys), static_cast<int32_t*>(out_vals), P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
