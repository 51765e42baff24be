// Asymmetric distance tables: (Q, M*dsub) queries x (M, C, dsub) codebook
// -> (Q, M, C).  l2: sum_d (q - c)^2; ip/angular: -sum_d q*c.
//
// Replaces the Pallas kernel src/repro/kernels/pq_adt.py::pq_adt.  Direct
// form, like the TPU kernel, and its reuse: the TPU kernel runs a block of
// q_block=8 queries against one codebook block, so each codebook value
// loaded serves eight queries.
//
// Bound: the (Q, M, C) float32 table it writes (8.4 MB at Q=256, M=32,
// C=256), against 32 KB of queries and 128 KB of codebook read.
//
// Design: a block owns a tile of kQB queries x MB subspaces (MB*ceil(C/4)
// <= 256 threads; MB=4 at C=256, so the grid is (Q/8, M/4) = (32, 8)).
// A thread owns 4 consecutive centroids c..c+3 of one subspace m: it loads
// them once into registers (at dsub=4, four 16-byte loads of 64 contiguous
// bytes that no other thread reads, so nothing is staged in shared memory),
// then, for each of the tile's kQB queries, reads the query's dsub values
// from shared memory (the same address across the warp: a broadcast) and
// writes out[q, m, c:c+4] as one 16-byte store.  Neighbouring threads own
// neighbouring centroids, so a warp's store is 512 contiguous bytes.  The
// stores carry no streaming hint: pq_lookup reads the table from L2 in the
// very next rounds.
//
// Ragged edges stay in this kernel: Q not a multiple of kQB and M not a
// multiple of MB are masked; C not a multiple of 4 takes scalar stores
// (kVecOut=false); dsub != 4, or a codebook not 16-byte aligned, reads the
// codebook with scalar loads inside the query loop (kDsub=0).
// Tile height: scripts/kernel_variants.py times kQB = 4, 8 and 16 (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PQ_ADT_QB
#define PQ_ADT_QB 8
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kQB = PQ_ADT_QB;               // queries per tile
constexpr int kSmemFloats = 48 * 1024 / 4;   // default dynamic smem limit

template <bool kL2>
__device__ __forceinline__ float term(float acc, float q, float c) {
  if (kL2) {
    const float d = q - c;
    return fmaf(d, d, acc);
  }
  return fmaf(q, c, acc);
}

// kDsub: 4 -> the thread's 4x4 centroid values live in registers, loaded
// as float4; 0 -> runtime dsub, centroid values read (through L1) for each
// query.  kVecOut: C % 4 == 0, so out[q, m, c:c+4] is one aligned float4.
template <bool kL2, int kDsub, bool kVecOut>
__global__ void __launch_bounds__(kThreads)
pq_adt_kernel(const float* __restrict__ queries,
              const float* __restrict__ cents, float* __restrict__ out,
              int Q, int M, int C, int dsub_rt, int MB) {
  extern __shared__ float qs[];                    // [kQB][MB * dsub]
  const int dsub = kDsub > 0 ? kDsub : dsub_rt;
  const int q0 = blockIdx.x * kQB;
  const int m0 = blockIdx.y * MB;
  const int mb = min(MB, M - m0);
  const int width = mb * dsub;                     // tile values per query
  const size_t D = static_cast<size_t>(M) * dsub;
  for (int i = threadIdx.x; i < kQB * width; i += blockDim.x) {
    const int qi = i / width, j = i - qi * width;
    qs[i] = q0 + qi < Q ? queries[(q0 + qi) * D + m0 * dsub + j] : 0.f;
  }
  __syncthreads();

  const int c4n = (C + 3) >> 2;
  for (int it = threadIdx.x; it < mb * c4n; it += blockDim.x) {
    const int ml = it / c4n;
    const int c = (it - ml * c4n) << 2;
    const int nc = min(4, C - c);
    const int m = m0 + ml;
    const float* cp = cents + (static_cast<size_t>(m) * C + c) * dsub;
    float cv[4][kDsub > 0 ? kDsub : 1];
    if constexpr (kDsub == 4) {
      const float4* c4 = reinterpret_cast<const float4*>(cp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = j < nc ? __ldg(c4 + j) : make_float4(0, 0, 0, 0);
        cv[j][0] = v.x; cv[j][1] = v.y; cv[j][2] = v.z; cv[j][3] = v.w;
      }
    }
    float* orow = out + (static_cast<size_t>(q0) * M + m) * C + c;
#pragma unroll
    for (int qi = 0; qi < kQB; ++qi) {
      if (q0 + qi >= Q) break;
      const float* qv = qs + qi * width + ml * dsub;
      float r[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (kDsub == 4) {
        const float4 v = *reinterpret_cast<const float4*>(qv);
        const float qd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int d = 0; d < 4; ++d) r[j] = term<kL2>(r[j], qd[d], cv[j][d]);
      } else {
        for (int j = 0; j < nc; ++j)
          for (int d = 0; d < dsub; ++d)
            r[j] = term<kL2>(r[j], qv[d], __ldg(cp + j * dsub + d));
      }
      if (!kL2) {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = -r[j];
      }
      if constexpr (kVecOut) {
        *reinterpret_cast<float4*>(orow) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
        for (int j = 0; j < nc; ++j) orow[j] = r[j];
      }
      orow += static_cast<size_t>(M) * C;
    }
  }
}

template <bool kL2, int kDsub, bool kVecOut>
void run(dim3 grid, int threads, size_t smem, cudaStream_t s,
         const float* q, const float* c, float* o, int Q, int M, int C,
         int dsub, int MB) {
  pq_adt_kernel<kL2, kDsub, kVecOut><<<grid, threads, smem, s>>>(
      q, c, o, Q, M, C, dsub, MB);
}

template <bool kL2>
void dispatch(dim3 grid, int threads, size_t smem, cudaStream_t s,
              const float* q, const float* c, float* o, int Q, int M, int C,
              int dsub, int MB) {
  const bool vec_in = dsub == 4 && (reinterpret_cast<uintptr_t>(c) & 15) == 0;
  const bool vec_out = C % 4 == 0;
  if (vec_in && vec_out) {
    run<kL2, 4, true>(grid, threads, smem, s, q, c, o, Q, M, C, dsub, MB);
  } else if (vec_in) {
    run<kL2, 4, false>(grid, threads, smem, s, q, c, o, Q, M, C, dsub, MB);
  } else if (vec_out) {
    run<kL2, 0, true>(grid, threads, smem, s, q, c, o, Q, M, C, dsub, MB);
  } else {
    run<kL2, 0, false>(grid, threads, smem, s, q, c, o, Q, M, C, dsub, MB);
  }
}

}  // namespace

extern "C" int pq_adt_launch(const void* queries, const void* cents, void* out,
                             int Q, int M, int C, int dsub, int l2,
                             void* stream) {
  if (Q == 0 || M == 0 || C == 0) return 0;
  if (dsub <= 0 || kQB * dsub > kSmemFloats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // subspaces per tile: as many as fill 256 threads with 4 centroids each,
  // and whose kQB query rows fit the default 48 KB of shared memory
  const int c4n = (C + 3) / 4;
  int MB = kThreads / c4n;
  MB = MB < 1 ? 1 : MB;
  MB = MB > M ? M : MB;
  const int mb_smem = kSmemFloats / (kQB * dsub);
  MB = MB > mb_smem ? mb_smem : MB;
  const int items = MB * c4n;
  const int threads = items >= kThreads ? kThreads : ((items + 31) / 32) * 32;
  const dim3 grid((Q + kQB - 1) / kQB, (M + MB - 1) / MB);
  const size_t smem = sizeof(float) * kQB * MB * dsub;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* c = static_cast<const float*>(cents);
  float* o = static_cast<float*>(out);
  if (l2) {
    dispatch<true>(grid, threads, smem, s, q, c, o, Q, M, C, dsub, MB);
  } else {
    dispatch<false>(grid, threads, smem, s, q, c, o, Q, M, C, dsub, MB);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
