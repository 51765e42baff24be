// Exact distances of candidate rows to their query.
//
// Replaces the Pallas kernel src/repro/kernels/l2_rerank.py::l2_rerank.  Two
// entry points, one kernel:
//   l2_rerank_launch         (Q, D) queries, (Q, K, D) gathered rows -> (Q, K)
//                            in the TPU kernel's expanded form, l2
//                            ||q||^2 - 2 q.x + ||x||^2, ip -q.x (the
//                            reference signature, kept for parity);
//   l2_rerank_masked_launch  (Q, D) queries, (Q, K) i32 ids, (N, D) base,
//                            (Q, K) f32 acc, (Q, K) bool mask -> (Q, K):
//                            where mask, the distance of base[id] in the
//                            direct form the search's jnp path computes
//                            (l2 sum (x - q)^2, ip -q.x); elsewhere acc,
//                            copied bit for bit.  The search's round and its
//                            beta-margin rerank call this one.
//
// Bound: bytes -- the rows the mask asks for (16.8 MB at Q=256, K=128,
// D=128 when all are asked for; a round asks for a few percent of them),
// plus the ids, mask, acc and output.  At a round's density the kernel is
// one dependent chain (ids -> rows -> reduce -> store), so latency, not
// bandwidth, sets its time.
//
// Design: one warp per window of kWindow=8 candidates of one query (a block
// holds kWarps windows; the grid is (Q, ceil(K / (8 * kWarps)))).  Lane j <
// 8 loads candidate j's id, mask bit and acc, and a ballot of the mask gives
// the rows to read; a row the mask does not ask for is never read, so its
// id is never dereferenced.  The warp issues the loads of all the window's
// asked-for rows (up to kRows=8) before it reduces any: at D=128 each lane
// loads one float4 of each row (a row is 512 contiguous bytes, one warp
// instruction) through the read-only path.  Small windows put every row of
// a (256, 128) batch in flight at once (4096 warps); at a round's density
// most windows ask for nothing and leave after one load.  The query row sits
// in registers, one float4 per lane at D <= 128 (kChunks=1); wider rows
// loop over 128-wide chunks and re-read the query through L1 (kChunks=0),
// and D % 4 != 0 or a misaligned pointer takes scalar loads (kV=1).  A
// butterfly of shuffles sums each row; the lane that owns the candidate
// keeps the result and stores it with the window's other outputs.
// ||q||^2 of the expanded form is summed once per warp, not per row.
// A masked id outside [0, N) traps instead of reading a wild row.
//
// Wide rows (masked entry, D > 128: the image retriever's 2048-d round):
// the design above would walk a row's D / 128 chunks one after another,
// each a dependent memory latency, in one warp.  Instead a block of
// kWideThreads threads takes a window of kWideWindow candidates, and each of
// its threads owns kWidePer = 2048 / kWideThreads of a row's elements (float4
// loads, or scalars) in every 2048-wide pass: every warp loads the window's
// ids and mask itself (the same ballot in each, no barrier), then issues the
// loads of its slices of up to kWideRows asked-for rows, with the query's
// slice beside them, before it reduces any.  The loads are unconditional: a
// slot with no row reads the query's own row, and an element past D reads
// element 0 and is not added.  So a row's bytes are all in flight after one
// ids -> rows latency, and a window's n asked-for rows take ceil(n /
// kWideRows) latencies.  The retriever's rounds ask for few rows, bunched in
// a few queries (scripts/retriever_round.py); the window and the rows in
// flight were chosen on its calls (scripts/kernel_variants.py --round,
// PERF.md).  A warp's butterfly sums its threads' partials; its lane 0 puts
// the row's partial into shared memory, one slot a (warp, candidate); after
// the one barrier, the lanes that own the candidates sum the warps' slots in
// warp order.  No atomics: two runs give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef L2_RERANK_ROWS
#define L2_RERANK_ROWS 8
#endif
#ifndef L2_RERANK_WINDOW
#define L2_RERANK_WINDOW 8
#endif
#ifndef L2_RERANK_WIDE_THREADS
#define L2_RERANK_WIDE_THREADS 512
#endif
#ifndef L2_RERANK_WIDE_WINDOW
#define L2_RERANK_WIDE_WINDOW 32
#endif
#ifndef L2_RERANK_WIDE_ROWS
#define L2_RERANK_WIDE_ROWS 8
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                 // warps per block
constexpr int kRows = L2_RERANK_ROWS;     // rows in flight per warp
constexpr int kWindow = L2_RERANK_WINDOW; // candidates per warp, <= 32
constexpr int kWideThreads = L2_RERANK_WIDE_THREADS;  // a wide block
constexpr int kWideWindow = L2_RERANK_WIDE_WINDOW;    // its candidates, <= 32
constexpr int kWideRows = L2_RERANK_WIDE_ROWS;        // rows in flight
constexpr int kWidePer = 2048 / kWideThreads;  // a thread's elements a pass
constexpr int kWideVec = kWidePer < 4 ? kWidePer : 4;  // of a vector load
static_assert(kWidePer >= 2 && kWidePer * kWideThreads == 2048,
              "kWideThreads: 128, 256, 512 or 1024");

enum Form { kDirectL2 = 0, kDot = 1, kExpandedL2 = 2 };

template <int kV> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<1> { using T = float; };

__device__ __forceinline__ float4 ld(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float2 ld(const float2* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 zero(float4) { return make_float4(0, 0, 0, 0); }
__device__ __forceinline__ float zero(float) { return 0.f; }

// acc += the form's per-element terms of (q, x); xx += x.x (expanded only)
template <int kForm>
__device__ __forceinline__ void add(float& acc, float& xx, float q, float x) {
  if (kForm == kDirectL2) {
    const float d = x - q;
    acc = fmaf(d, d, acc);
  } else {
    acc = fmaf(q, x, acc);
    if (kForm == kExpandedL2) xx = fmaf(x, x, xx);
  }
}

template <int kForm>
__device__ __forceinline__ void add(float& acc, float& xx, float2 q, float2 x) {
  add<kForm>(acc, xx, q.x, x.x);
  add<kForm>(acc, xx, q.y, x.y);
}

template <int kForm>
__device__ __forceinline__ void add(float& acc, float& xx, float4 q, float4 x) {
  add<kForm>(acc, xx, q.x, x.x);
  add<kForm>(acc, xx, q.y, x.y);
  add<kForm>(acc, xx, q.z, x.z);
  add<kForm>(acc, xx, q.w, x.w);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// kMasked: ids/mask/acc given, rows gathered from base; else the (Q, K, D)
// rows are pre-gathered and every candidate is computed.  kV: 4 (float4)
// or 1 (scalar) elements a lane per 32-lane chunk.  kChunks: 1 -> D fits
// one chunk and the query is held in registers; 0 -> runtime chunk count.
template <int kForm, bool kMasked, int kV, int kChunks>
__global__ void __launch_bounds__(32 * kWarps)
l2_rerank_kernel(const float* __restrict__ queries,
                 const float* __restrict__ rows,
                 const int32_t* __restrict__ ids,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ acc,
                 float* __restrict__ out, int K, int D, int N) {
  using V = typename VecOf<kV>::T;
  constexpr int kChunk = 32 * kV;         // elements per chunk
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x;
  const int k0 = (blockIdx.y * kWarps + (threadIdx.x >> 5)) * kWindow;
  if (k0 >= K) return;                    // the whole warp leaves
  const int k = k0 + lane;
  const bool in = lane < kWindow && k < K;
  const size_t qk = static_cast<size_t>(q) * K + k;
  const float* qrow = queries + static_cast<size_t>(q) * D;
  const int nch = kChunks > 0 ? kChunks : (D + kChunk - 1) / kChunk;

  bool want = in;
  int id = 0;
  float res = 0.f;
  if (kMasked && in) {
    want = __ldg(mask + qk) != 0;
    id = __ldg(ids + qk);
    res = __ldg(acc + qk);                // kept where the mask is False
    if (want && (id < 0 || id >= N)) __trap();
  }
  unsigned todo = __ballot_sync(kFull, want);
  if (!todo) {
    if (in) out[qk] = res;
    return;
  }

  V qreg[kChunks > 0 ? kChunks : 1];
  if constexpr (kChunks > 0) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = (c * 32 + lane) * kV;
      qreg[c] = e < D ? ld(reinterpret_cast<const V*>(qrow + e)) : zero(V());
    }
  }
  // the lane's part of query chunk c: from registers, or through L1
  auto qchunk = [&](int c) -> V {
    if constexpr (kChunks > 0) {
      return qreg[c];
    } else {
      const int e = (c * 32 + lane) * kV;
      return e < D ? ld(reinterpret_cast<const V*>(qrow + e)) : zero(V());
    }
  };
  float qq = 0.f;
  if (kForm == kExpandedL2) {
    float unused = 0.f;
#pragma unroll
    for (int c = 0; c < nch; ++c) {
      const V qv = qchunk(c);
      add<kDot>(qq, unused, qv, qv);
    }
    qq = warp_sum(qq);
  }

  while (todo) {
    int pos[kRows];
    const float* src[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      pos[r] = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;                   // 0 stays 0
      if (kMasked) {
        const int rid = __shfl_sync(kFull, id, pos[r] < 0 ? 0 : pos[r]);
        src[r] = rows + static_cast<size_t>(rid) * D;
      } else {
        src[r] = rows + (static_cast<size_t>(q) * K + k0 + max(pos[r], 0)) * D;
      }
    }
    float s[kRows], xx[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = xx[r] = 0.f;
#pragma unroll
    for (int c = 0; c < nch; ++c) {
      const int e = (c * 32 + lane) * kV;
      V x[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        x[r] = pos[r] >= 0 && e < D ? ld(reinterpret_cast<const V*>(src[r] + e))
                                    : zero(V());
      }
      const V qv = qchunk(c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) add<kForm>(s[r], xx[r], qv, x[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (pos[r] < 0) break;              // the same for the whole warp
      float d = warp_sum(s[r]);
      if (kForm == kExpandedL2) d = (qq - 2.f * d) + warp_sum(xx[r]);
      if (kForm == kDot) d = -d;
      if (lane == pos[r]) res = d;
    }
  }
  if (in) out[qk] = res;
}

// The wide path (the header): masked entry, direct l2 or dot form.  kV:
// kWideVec (float4; float2 at 1024 threads) or 1 (scalar) elements a load;
// a thread loads kWidePer / kV of them a row and pass.
template <int kForm, int kV>
__global__ void __launch_bounds__(kWideThreads)
l2_rerank_wide_kernel(const float* __restrict__ queries,
                      const float* __restrict__ base,
                      const int32_t* __restrict__ ids,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ acc,
                      float* __restrict__ out, int K, int D, int N) {
  using V = typename VecOf<kV>::T;
  constexpr int kWarpsW = kWideThreads / 32;
  constexpr int kLd = kWidePer / kV;      // loads a row and pass
  constexpr int kPass = kWidePer * kWideThreads;   // elements a pass
  __shared__ float part[kWarpsW][kWideWindow];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x;
  const int k = blockIdx.y * kWideWindow + lane;
  const bool in = lane < kWideWindow && k < K;
  const size_t qk = static_cast<size_t>(q) * K + k;
  const float* qrow = queries + static_cast<size_t>(q) * D;

  // every warp reads the window itself: the same ballot in each
  bool want = false;
  int id = 0;
  float res = 0.f;
  if (in) {
    want = __ldg(mask + qk) != 0;
    id = __ldg(ids + qk);
    res = __ldg(acc + qk);                // kept where the mask is False
    if (want && (id < 0 || id >= N)) __trap();
  }
  unsigned todo = __ballot_sync(kFull, want);
  if (!todo) {                            // the same for the whole block
    if (warp == 0 && in) out[qk] = res;
    return;
  }

  // element of load j of a pass: the warp's 32 lanes side by side
  auto elem = [&](int p0, int j) {
    return p0 + ((j * kWarpsW + warp) * 32 + lane) * kV;
  };
  while (todo) {
    int pos[kWideRows];
    const float* src[kWideRows];
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
      pos[r] = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;                   // 0 stays 0
      const int rid = __shfl_sync(kFull, id, pos[r] < 0 ? 0 : pos[r]);
      src[r] = pos[r] >= 0 ? base + static_cast<size_t>(rid) * D : qrow;
    }
    float s[kWideRows];
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) s[r] = 0.f;
    for (int p0 = 0; p0 < D; p0 += kPass) {
      V qv[kLd], x[kWideRows][kLd];
      bool live[kLd];
#pragma unroll
      for (int j = 0; j < kLd; ++j) {
        live[j] = elem(p0, j) < D;
        const int e = live[j] ? elem(p0, j) : 0;
        qv[j] = ld(reinterpret_cast<const V*>(qrow + e));
#pragma unroll
        for (int r = 0; r < kWideRows; ++r) {
          x[r][j] = ld(reinterpret_cast<const V*>(src[r] + e));
        }
      }
      float unused = 0.f;
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) {
#pragma unroll
        for (int j = 0; j < kLd; ++j) {
          if (live[j]) add<kForm>(s[r], unused, qv[j], x[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
      if (pos[r] < 0) break;              // the same for the whole warp
      const float w = warp_sum(s[r]);
      if (lane == 0) part[warp][pos[r]] = w;
    }
  }
  __syncthreads();
  if (warp == 0 && in) {
    if (want) {
      float d = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsW; ++w) d += part[w][lane];
      res = kForm == kDot ? -d : d;
    }
    out[qk] = res;
  }
}

template <int kForm>
int launch_wide(const float* queries, const float* base, const int32_t* ids,
                const uint8_t* mask, const float* acc, float* out, int Q,
                int K, int D, int N, bool vec, cudaStream_t s) {
  const dim3 grid(Q, (K + kWideWindow - 1) / kWideWindow);
  if (vec) {
    l2_rerank_wide_kernel<kForm, kWideVec><<<grid, kWideThreads, 0, s>>>(
        queries, base, ids, mask, acc, out, K, D, N);
  } else {
    l2_rerank_wide_kernel<kForm, 1><<<grid, kWideThreads, 0, s>>>(
        queries, base, ids, mask, acc, out, K, D, N);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kForm, bool kMasked>
int launch(const float* queries, const float* rows, const int32_t* ids,
           const uint8_t* mask, const float* acc, float* out, int Q, int K,
           int D, int N, cudaStream_t s) {
  if (Q == 0 || K == 0) return 0;
  const dim3 grid(Q, (K + kWindow * kWarps - 1) / (kWindow * kWarps));
  const int threads = 32 * kWarps;
  const bool vec = D % 4 == 0
      && ((reinterpret_cast<uintptr_t>(queries)
           | reinterpret_cast<uintptr_t>(rows)) & 15) == 0;
  const bool one_chunk = D <= (vec ? 128 : 32);
  if constexpr (kMasked) {
    if (D > 128) {
      return launch_wide<kForm>(queries, rows, ids, mask, acc, out, Q, K, D,
                                N, vec, s);
    }
  }
#define L2R_RUN(V, CH)                                                      \
  l2_rerank_kernel<kForm, kMasked, V, CH><<<grid, threads, 0, s>>>(         \
      queries, rows, ids, mask, acc, out, K, D, N)
  if (vec && one_chunk) {
    L2R_RUN(4, 1);
  } else if (vec) {
    L2R_RUN(4, 0);
  } else if (one_chunk) {
    L2R_RUN(1, 1);
  } else {
    L2R_RUN(1, 0);
  }
#undef L2R_RUN
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int l2_rerank_launch(const void* queries, const void* cands,
                                void* out, int Q, int K, int D, int l2,
                                void* stream) {
  const float* qp = static_cast<const float*>(queries);
  const float* cp = static_cast<const float*>(cands);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l2) {
    return launch<kExpandedL2, false>(qp, cp, nullptr, nullptr, nullptr, op,
                                      Q, K, D, 0, s);
  }
  return launch<kDot, false>(qp, cp, nullptr, nullptr, nullptr, op, Q, K, D,
                             0, s);
}

extern "C" int l2_rerank_masked_launch(const void* queries, const void* ids,
                                       const void* base, const void* acc,
                                       const void* mask, void* out, int Q,
                                       int K, int D, int N, int l2,
                                       void* stream) {
  const float* qp = static_cast<const float*>(queries);
  const float* bp = static_cast<const float*>(base);
  const int32_t* ip = static_cast<const int32_t*>(ids);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  const float* ap = static_cast<const float*>(acc);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l2) {
    return launch<kDirectL2, true>(qp, bp, ip, mp, ap, op, Q, K, D, N, s);
  }
  return launch<kDot, true>(qp, bp, ip, mp, ap, op, Q, K, D, N, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
