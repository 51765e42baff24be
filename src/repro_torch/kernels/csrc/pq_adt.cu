// Asymmetric distance tables: (Q, M*dsub) queries x (M, C, dsub) codebook
// -> (Q, M, C).  l2: sum_d (q - c)^2; ip/angular: -sum_d q*c.
//
// Replaces the Pallas kernel src/repro/kernels/pq_adt.py::pq_adt.  Direct
// form, like the TPU kernel, and its reuse: the TPU kernel runs a block of
// q_block=8 queries against one codebook block, so each codebook value
// loaded serves eight queries.
//
// Two kernels.  The search's codebooks (dsub=4, 16-byte aligned) take
// pq_adt_kernel; every other dsub, and a codebook that is not 16-byte
// aligned, takes pq_adt_wide_kernel.
//
// pq_adt_kernel.  Bound: the (Q, M, C) float32 table it writes (8.4 MB at
// Q=256, M=32, C=256), against 32 KB of queries and 128 KB of codebook read.
// Design: a block owns a tile of kQB queries x MB subspaces (MB*ceil(C/4)
// <= 256 threads; MB=4 at C=256, so the grid is (Q/8, M/4) = (32, 8)).
// A thread owns 4 consecutive centroids c..c+3 of one subspace m: it loads
// them once into registers (four 16-byte loads of 64 contiguous bytes that
// no other thread reads, so nothing is staged in shared memory), then, for
// each of the tile's kQB queries, reads the query's dsub values from shared
// memory (the same address across the warp: a broadcast) and writes
// out[q, m, c:c+4] as one 16-byte store.  Neighbouring threads own
// neighbouring centroids, so a warp's store is 512 contiguous bytes.  The
// stores carry no streaming hint: pq_lookup reads the table from L2 in the
// very next rounds.  Q not a multiple of kQB and M not a multiple of MB are
// masked; C not a multiple of 4 takes scalar stores (kVecOut=false).
// Tile height: scripts/kernel_variants.py times kQB = 4, 8 and 16 (PERF.md).
//
// pq_adt_wide_kernel.  Bound: operations once dsub is wide (the image
// retriever's (256, 2048) x (32, 256, 64): 268 MFLOP against 2.1 MB read
// and 8.4 MB written).  Design: the SIMT form of a batched product over the
// M subspaces.  A block of 128 threads owns kWQ=32 queries x one subspace m
// x kWC=64 centroids.  It walks dsub in chunks of kWD=32: each chunk of the
// centroid slab cents[m, c0:c0+64, d0:d0+32] and of the query tile is
// staged in shared memory with coalesced 16-byte loads (dsub % 4 == 0 and
// both pointers aligned, else scalar loads), transposed to [d][c] and
// [d][q], so at each d a warp reads 16 consecutive float4s of centroids (no
// bank conflict) and two float4s of queries (broadcasts).  Each thread
// keeps a 4 x 4 register tile (queries 4*qg.., centroids 4*cg..), sums it
// over d in ascending order with fmaf, in full fp32 on the CUDA cores, and
// writes out[q, m, c:c+4] as one 16-byte store where C % 4 == 0.  Q, C and
// the last dsub chunk are masked.  Shared memory is 13,312 bytes a block
// whatever dsub is.  Tile: scripts/kernel_variants.py times 8 queries a
// thread and chunks of 64 (PQ_ADT_WIDE_TQ, PQ_ADT_WIDE_D); none is faster.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PQ_ADT_QB
#define PQ_ADT_QB 8
#endif
#ifndef PQ_ADT_WIDE_TQ
#define PQ_ADT_WIDE_TQ 4
#endif
#ifndef PQ_ADT_WIDE_D
#define PQ_ADT_WIDE_D 32
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

// kDsub: 4, the thread's 4x4 centroid values live in registers, loaded as
// float4 (every other dsub takes pq_adt_wide_kernel).  kVecOut: C % 4 == 0,
// so out[q, m, c:c+4] is one aligned float4.
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

constexpr int kWThreads = 128;   // 16 centroid groups x 8 query groups
constexpr int kWTQ = PQ_ADT_WIDE_TQ;  // queries a thread (4 or 8)
constexpr int kWQ = 8 * kWTQ;    // queries per tile
constexpr int kWC = 64;          // centroids per tile (16 groups of 4)
constexpr int kWD = PQ_ADT_WIDE_D;    // dsub values per staged chunk
constexpr int kWCS = kWC + 4;    // row stride of the staged [d][c] slab
constexpr int kWQS = kWQ + 4;    // row stride of the staged [d][q] tile
static_assert(kWTQ % 4 == 0 && kWD % 4 == 0, "float4 tiles");

// Stage rows [0, n) x values [d0, d0 + dk) of a row-major source (row
// stride ld floats) transposed into dst[d][r] (row stride ldd), zeros for
// rows n..R-1.  Consecutive threads read consecutive 16 bytes of a row, so
// a warp's loads are coalesced (its transposed stores conflict 4-way; the
// mapping with conflict-free stores and scattered loads was slower, PERF.md).
template <bool kVec, int R>
__device__ __forceinline__ void stage(float* __restrict__ dst, int ldd,
                                      const float* __restrict__ src,
                                      size_t ld, int n, int d0, int dk) {
  if constexpr (kVec) {
    const int f4 = dk >> 2;                        // float4s a staged row
    for (int i = threadIdx.x; i < R * f4; i += kWThreads) {
      const int r = i / f4, f = (i - r * f4) << 2;
      const float4 v = r < n ? __ldg(reinterpret_cast<const float4*>(
                                   src + r * ld + d0 + f))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[f * ldd + r] = v.x;
      dst[(f + 1) * ldd + r] = v.y;
      dst[(f + 2) * ldd + r] = v.z;
      dst[(f + 3) * ldd + r] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < R * dk; i += kWThreads) {
      const int r = i / dk, j = i - r * dk;
      dst[j * ldd + r] = r < n ? __ldg(src + r * ld + d0 + j) : 0.f;
    }
  }
}

// Any dsub.  kVecIn: dsub % 4 == 0 and both inputs 16-byte aligned, so the
// chunks are staged with float4 loads.  kVecOut as above.
template <bool kL2, bool kVecIn, bool kVecOut>
__global__ void __launch_bounds__(kWThreads)
pq_adt_wide_kernel(const float* __restrict__ queries,
                   const float* __restrict__ cents, float* __restrict__ out,
                   int Q, int M, int C, int dsub) {
  __shared__ __align__(16) float cs[kWD * kWCS];   // [d][c] of the chunk
  __shared__ __align__(16) float qs[kWD * kWQS];   // [d][q] of the chunk
  const int q0 = blockIdx.x * kWQ;
  const int m = blockIdx.y;
  const int c0 = blockIdx.z * kWC;
  const int cg = threadIdx.x & 15, qg = threadIdx.x >> 4;
  const size_t D = static_cast<size_t>(M) * dsub;
  const float* cbase = cents + (static_cast<size_t>(m) * C + c0) * dsub;
  const float* qbase = queries + static_cast<size_t>(q0) * D +
                       static_cast<size_t>(m) * dsub;
  float acc[kWTQ][4] = {};
  for (int d0 = 0; d0 < dsub; d0 += kWD) {
    const int dk = min(kWD, dsub - d0);
    if (d0 > 0) __syncthreads();                   // last chunk consumed
    stage<kVecIn, kWC>(cs, kWCS, cbase, dsub, min(kWC, C - c0), d0, dk);
    stage<kVecIn, kWQ>(qs, kWQS, qbase, D, min(kWQ, Q - q0), d0, dk);
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < dk; ++d) {
      const float4 cv = *reinterpret_cast<const float4*>(cs + d * kWCS + 4 * cg);
      const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
      float qq[kWTQ];
#pragma unroll
      for (int i = 0; i < kWTQ; i += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(
            qs + d * kWQS + kWTQ * qg + i);
        qq[i] = qv.x; qq[i + 1] = qv.y; qq[i + 2] = qv.z; qq[i + 3] = qv.w;
      }
#pragma unroll
      for (int i = 0; i < kWTQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = term<kL2>(acc[i][j], qq[i], cc[j]);
    }
  }
  const int c = c0 + 4 * cg;
  if (c >= C) return;
#pragma unroll
  for (int i = 0; i < kWTQ; ++i) {
    const int q = q0 + kWTQ * qg + i;
    if (q >= Q) break;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = kL2 ? acc[i][j] : -acc[i][j];
    float* o = out + (static_cast<size_t>(q) * M + m) * C + c;
    if constexpr (kVecOut) {
      *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
      for (int j = 0; j < min(4, C - c); ++j) o[j] = r[j];
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
  if (C % 4 == 0) {
    run<kL2, 4, true>(grid, threads, smem, s, q, c, o, Q, M, C, dsub, MB);
  } else {
    run<kL2, 4, false>(grid, threads, smem, s, q, c, o, Q, M, C, dsub, MB);
  }
}

template <bool kL2, bool kVecIn, bool kVecOut>
void run_wide(cudaStream_t s, const float* q, const float* c, float* o, int Q,
              int M, int C, int dsub) {
  const dim3 grid((Q + kWQ - 1) / kWQ, M, (C + kWC - 1) / kWC);
  pq_adt_wide_kernel<kL2, kVecIn, kVecOut><<<grid, kWThreads, 0, s>>>(
      q, c, o, Q, M, C, dsub);
}

template <bool kL2>
void dispatch_wide(cudaStream_t s, const float* q, const float* c, float* o,
                   int Q, int M, int C, int dsub) {
  const bool vec_in = dsub % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(c)) &
       15) == 0;
  const bool vec_out = C % 4 == 0;
  if (vec_in && vec_out) {
    run_wide<kL2, true, true>(s, q, c, o, Q, M, C, dsub);
  } else if (vec_in) {
    run_wide<kL2, true, false>(s, q, c, o, Q, M, C, dsub);
  } else if (vec_out) {
    run_wide<kL2, false, true>(s, q, c, o, Q, M, C, dsub);
  } else {
    run_wide<kL2, false, false>(s, q, c, o, Q, M, C, dsub);
  }
}

}  // namespace

extern "C" int pq_adt_launch(const void* queries, const void* cents, void* out,
                             int Q, int M, int C, int dsub, int l2,
                             void* stream) {
  if (Q == 0 || M == 0 || C == 0) return 0;
  if (dsub <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* c = static_cast<const float*>(cents);
  float* o = static_cast<float*>(out);
  if (dsub != 4 || (reinterpret_cast<uintptr_t>(c) & 15) != 0) {
    if (M > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
    if (l2) {
      dispatch_wide<true>(s, q, c, o, Q, M, C, dsub);
    } else {
      dispatch_wide<false>(s, q, c, o, Q, M, C, dsub);
    }
    return static_cast<int>(cudaGetLastError());
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
