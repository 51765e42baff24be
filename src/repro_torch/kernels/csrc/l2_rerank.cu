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
// Window and rows in flight: scripts/kernel_variants.py times the
// alternatives (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef L2_RERANK_ROWS
#define L2_RERANK_ROWS 8
#endif
#ifndef L2_RERANK_WINDOW
#define L2_RERANK_WINDOW 8
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                 // warps per block
constexpr int kRows = L2_RERANK_ROWS;     // rows in flight per warp
constexpr int kWindow = L2_RERANK_WINDOW; // candidates per warp, <= 32

enum Form { kDirectL2 = 0, kDot = 1, kExpandedL2 = 2 };

template <int kV> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<1> { using T = float; };

__device__ __forceinline__ float4 ld(const float4* p) { return __ldg(p); }
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
