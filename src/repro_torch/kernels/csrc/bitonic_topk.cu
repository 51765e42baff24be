// Row-wise ascending sort of (Q, P) float keys carrying an int32 payload, P a
// power of two, and the search's merge of a candidate list with its fresh
// candidates, which keeps the top L.
//
// Replaces the Pallas kernel src/repro/kernels/bitonic_topk.py::
// bitonic_sort_pairs (the paper's shared Bitonic Sorter) and, for the merge,
// the glue around it in the reference's _merge_sort_topl (concatenations,
// padding, the position payload and four gathers), which here is one launch.
//
// Order.  Each element is one 64-bit word: the high 32 bits are its key mapped
// to an order-preserving uint32 (-0.0 first made +0.0; then a set sign bit
// flips every bit, a clear one is set), the low 32 bits its position in the
// row.  One integer compare is the total order (key, position), so the network
// is the stable sort: ties, -0.0 against +0.0 among them, keep input order,
// exactly like torch.sort(stable=True) and the reference's
// jnp.argsort(stable=True).  Keys must not be NaN.  Keys and payload are read
// back through the position.
//
// Bound: latency.  A row needs log2(P)(log2(P)+1)/2 dependent compare stages
// (36 at P=256); the bytes (16 per element for the sort, 26 per kept list
// entry for the merge) take well under a microsecond at a round's Q=256.
// Design against it:
// * A row of up to 1024 elements lives in one warp's registers: lane l holds
//   elements l*E ... l*E+E-1 (E = P/32).  Stages of stride below E compare
//   inside the thread, the others trade with __shfl_xor_sync.  No shared
//   memory, no barrier, 4 rows per block.
// * The merge sorts only what is unsorted.  The list is sorted already (the
//   previous round's merge wrote it), so only the n fresh keys go through a
//   full network, in a register array of their own (descending,
//   next_pow2(n) >= 32 wide), and are then moved by shuffles to the end of
//   the row.  [list ascending | +inf padding | fresh descending] is one
//   bitonic sequence, and a single merge phase of log2(P) stages sorts it.
//   At L=128, n=64 that is 21 stages over 2 elements a lane and 8 over 8,
//   instead of 36 over 8.  The precondition is checked: a warp vote over the
//   list's neighbouring pairs, and a trap if any pair is out of order.
// * The list's payload columns are prefetched into L2 while the network
//   runs, so the gathers that write the new list do not wait on DRAM.
// * A merge whose row exceeds one warp (L + fresh slots > 1024, up to
//   16384), or whose list is 256 or longer (where it beat the warp merge on
//   the H100, PERF.md), ranks instead of sorting: one block a row.  Warp r
//   sorts fresh words r*1024 ... in registers as above (ascending) and the
//   list's L words go to shared memory; one barrier in all.  Then every
//   element takes as its output slot its own index plus the number of words
//   below it in each other sorted run, by binary search in shared memory: no
//   two words are equal (positions differ), so the slots are the stable
//   sort's.  Each list word also checks that it is below its successor and
//   traps if not.  Elements whose slot is below L store their four columns
//   there; the list's payload was prefetched into L2 before the barrier.
// * Sorts longer than a warp's 1024 elements (up to 16384) run in one block
//   over shared memory, one barrier per stage, with the pair index computed
//   by shifts and masks.
//
// Entry points:
//   bitonic_sort_launch   (Q, P) f32 keys, (Q, P) i32 payload -> both sorted;
//   bitonic_merge_launch  a lane's list, (Q, L) i32 ids, f32 dists (sorted
//                         ascending), f32 acc, bool evaluated, and its (Q, n)
//                         i32 / f32 fresh ids and distances -> the top L of
//                         the L + n entries by (distance, position), all four
//                         columns; fresh entries are positions L ... L+n-1
//                         and get acc = +inf, evaluated = false.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr u64 kPad = ~0ull;      // sorts after every real element
constexpr unsigned kAll = 0xffffffffu;
constexpr int kWarpRows = 4;     // rows (warps) per block on the warp path
constexpr int kWarpMax = 1024;   // longest row one warp holds
// the shortest list the rank merge takes (it also takes every row longer
// than a warp holds); a compile-time setting, so that
// scripts/kernel_variants.py can move the boundary (0: every merge ranks)
#ifndef BITONIC_RANK_FROM
#define BITONIC_RANK_FROM 256
#endif

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x >> 1);
}

__device__ __forceinline__ u64 pack(float key, int pos) {
  unsigned u = __float_as_uint(__fadd_rn(key, 0.0f));   // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | static_cast<unsigned>(pos);
}

__device__ __forceinline__ int position(u64 x) {
  return static_cast<int>(static_cast<unsigned>(x));
}

// What one row is made of and where its sorted prefix goes.
struct SortRows {
  const float* keys;
  const int32_t* vals;
  float* out_keys;
  int32_t* out_vals;
  int P;
  __device__ u64 load(int row, int i) const {
    return pack(keys[(size_t)row * P + i], i);
  }
  __device__ void store(int row, int i, int pos) const {
    const size_t r = (size_t)row * P;
    out_keys[r + i] = keys[r + pos];
    out_vals[r + i] = vals[r + pos];
  }
};

struct MergeRows {
  const int32_t* ids;
  const float* dists;
  const float* acc;
  const uint8_t* evaluated;
  const int32_t* n_ids;
  const float* n_dists;
  int32_t* out_ids;
  float* out_dists;
  float* out_acc;
  uint8_t* out_evaluated;
  int L, n;
  __device__ u64 load_list(int row, int i) const {
    return pack(dists[(size_t)row * L + i], i);
  }
  __device__ u64 load_fresh(int row, int j) const {
    return pack(n_dists[(size_t)row * n + j], L + j);
  }
  // Selects, not branches: a warp's lanes mix list and fresh sources, and
  // without divergence the loads of all slots issue together.
  __device__ void store(int row, int i, int pos) const {
    const size_t o = (size_t)row * L + i;
    const bool old = pos < L;
    const size_t s =
        old ? (size_t)row * L + pos : (size_t)row * n + (pos - L);
    out_ids[o] = (old ? ids : n_ids)[s];
    out_dists[o] = (old ? dists : n_dists)[s];
    out_acc[o] = old ? acc[s] : INFINITY;
    out_evaluated[o] = old ? evaluated[s] : 0;
  }
};

// Phases LO..HI of the bitonic network over the 32*E elements of a[], lane l
// holding elements l*E ... l*E+E-1 (phase lk turns runs of 2^(lk-1) into
// sorted runs of 2^lk, ascending where bit lk of the index is clear; DESC
// flips every direction).  Fully unrolled, so every slot index is a
// constant.
template <int E, int LO, int HI, bool DESC>
__device__ __forceinline__ void network(u64 (&a)[E], int lane) {
#pragma unroll
  for (int lk = LO; lk <= HI; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j < E) {                     // partner: slot e ^ j, same lane
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & j) continue;
          const bool up = (((lane * E + e) & k) == 0) != DESC;
          const u64 x = a[e], y = a[e | j];
          const bool swap = (x > y) == up;
          a[e] = swap ? y : x;
          a[e | j] = swap ? x : y;
        }
      } else {                         // partner: lane ^ (j / E), same slot
        const int d = j / E;
        const bool lower = (lane & d) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const bool up = (((lane * E + e) & k) == 0) != DESC;
          const u64 x = a[e];
          const u64 y = __shfl_xor_sync(kAll, x, d);
          a[e] = ((x < y) == (lower == up)) ? x : y;
        }
      }
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <int E>
__global__ void __launch_bounds__(32 * kWarpRows)
warp_sort_kernel(SortRows rows, int Q) {
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= Q) return;                // whole warps leave together
  const int lane = threadIdx.x & 31;
  u64 a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    a[e] = i < rows.P ? rows.load(row, i) : kPad;
  }
  network<E, 1, 5 + ilog2(E), false>(a, lane);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    if (i < rows.P) rows.store(row, i, position(a[e]));
  }
}

// E elements a lane in all (P = 32 E); the fresh keys, Pf = 32 F of them with
// padding, take the last Pf positions.
template <int E, int F>
__global__ void __launch_bounds__(32 * kWarpRows)
warp_merge_kernel(MergeRows rows, int Q) {
  static_assert(2 * F <= E, "the list needs at least half the row");
  constexpr int kFreshBase = 32 * (E - F);   // first fresh position
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= Q) return;
  const int lane = threadIdx.x & 31;
  const int L = rows.L;
  // the fresh keys, lane l holding l*F ... l*F+F-1: a full network of their
  // own, descending
  u64 f[F];
#pragma unroll
  for (int e = 0; e < F; ++e) {
    const int j = lane * F + e;
    f[e] = j < rows.n ? rows.load_fresh(row, j) : kPad;
  }
  if (lane * F < rows.n)
    prefetch_l2(rows.n_ids + (size_t)row * rows.n + lane * F);
  // the list, then +inf padding; its payload goes to L2 meanwhile
  u64 a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    a[e] = i < L ? rows.load_list(row, i) : kPad;
  }
  if (lane * E < L) {
    const size_t at = (size_t)row * L + lane * E;
    prefetch_l2(rows.ids + at);
    prefetch_l2(rows.acc + at);
    prefetch_l2(rows.evaluated + at);
  }
  network<F, 1, 5 + ilog2(F), true>(f, lane);
  // precondition: every list word below its successor
  const u64 next_lane = __shfl_down_sync(kAll, a[0], 1);
  bool unsorted = false;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const u64 next = e + 1 < E ? a[e + 1] : next_lane;
    unsorted |= lane * E + e + 1 < L && !(a[e] < next);
  }
  if (__any_sync(kAll, unsorted)) __trap();
  // move fresh element j to position kFreshBase + j: lane l's slot e wants
  // j = l*E + e - kFreshBase, held by lane j / F in slot j % F = e % F
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    const u64 v = __shfl_sync(kAll, f[e % F], ((i - kFreshBase) / F) & 31);
    if (i >= kFreshBase) a[e] = v;
  }
  // [ascending | padding | descending] is bitonic: one merge phase sorts it
  network<E, 5 + ilog2(E), 5 + ilog2(E), false>(a, lane);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    if (i < L) rows.store(row, i, position(a[e]));
  }
}

// The number of words of the ascending run a[0 .. len) below x.
__device__ __forceinline__ int below(const u64* a, int len, u64 x) {
  int at = 0;
  for (int step = len > 0 ? 1 << (31 - __clz(len)) : 0; step > 0;
       step >>= 1) {
    if (at + step <= len && a[at + step - 1] < x) at += step;
  }
  return at;
}

constexpr int kRankThreads = 256;  // threads a row on the rank merge
constexpr int kRankItems = 4;      // list words a thread a sweep

// The rank merge of one row a block.  Fresh words come in runs of 32 F
// (one run unless n > 1024), each sorted ascending by one warp in registers;
// dynamic shared memory holds the list's L words, then the runs.
template <int F>
__global__ void __launch_bounds__(kRankThreads)
rank_merge_kernel(MergeRows rows) {
  constexpr int kRun = 32 * F;
  constexpr int kSweep = kRankThreads * kRankItems;
  extern __shared__ u64 s_words[];
  const int L = rows.L, n = rows.n;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int runs = (n + kRun - 1) / kRun;
  u64* s_list = s_words;
  u64* s_fresh = s_words + L;
  const size_t base = (size_t)row * L, fbase = (size_t)row * n;
  // warp r's fresh words of run r (its first run), loaded first
  u64 f[F];
  auto load_run = [&](int r) {
#pragma unroll
    for (int e = 0; e < F; ++e) {
      const int j = r * kRun + lane * F + e;
      f[e] = j < n ? rows.load_fresh(row, j) : kPad;
    }
  };
  if (warp < runs) load_run(warp);
  // the list's words, coalesced, a sweep's loads issued before any is used;
  // its payload and the fresh ids go to L2 meanwhile
  for (int p0 = 0; p0 < L; p0 += kSweep) {
    float d[kRankItems];
#pragma unroll
    for (int k = 0; k < kRankItems; ++k) {
      const int p = p0 + tid + k * kRankThreads;
      d[k] = p < L ? rows.dists[base + p] : 0.f;
      if (p < L && (p & 31) == 0) {
        prefetch_l2(rows.ids + base + p);
        prefetch_l2(rows.acc + base + p);
        if ((p & 127) == 0) prefetch_l2(rows.evaluated + base + p);
      }
    }
#pragma unroll
    for (int k = 0; k < kRankItems; ++k) {
      const int p = p0 + tid + k * kRankThreads;
      if (p < L) s_list[p] = pack(d[k], p);
    }
  }
  for (int j = tid * 32; j < n; j += kRankThreads * 32)
    prefetch_l2(rows.n_ids + fbase + j);
  // warp r sorts run r (and r + 8, ...)
  for (int r = warp; r < runs; r += kRankThreads / 32) {
    if (r != warp) load_run(r);
    network<F, 1, 5 + ilog2(F), false>(f, lane);
#pragma unroll
    for (int e = 0; e < F; ++e) s_fresh[r * kRun + lane * F + e] = f[e];
  }
  __syncthreads();
  // list word p: slot p + the fresh words below it; the precondition
  // (every word below its successor) checked on the way, a trap if not
  for (int p0 = 0; p0 < L; p0 += kSweep) {
    float d[kRankItems], ac[kRankItems];
    int32_t id[kRankItems];
    uint8_t ev[kRankItems];
#pragma unroll
    for (int k = 0; k < kRankItems; ++k) {
      const int p = p0 + tid + k * kRankThreads;
      const bool in = p < L;
      d[k] = in ? rows.dists[base + p] : 0.f;
      id[k] = in ? rows.ids[base + p] : 0;
      ac[k] = in ? rows.acc[base + p] : 0.f;
      ev[k] = in ? rows.evaluated[base + p] : 0;
    }
#pragma unroll
    for (int k = 0; k < kRankItems; ++k) {
      const int p = p0 + tid + k * kRankThreads;
      if (p >= L) continue;
      const u64 w = s_list[p];
      if (p + 1 < L && !(w < s_list[p + 1])) __trap();
      int slot = p;
      for (int r = 0; r < runs; ++r)
        slot += below(s_fresh + r * kRun, min(kRun, n - r * kRun), w);
      if (slot < L) {
        const size_t o = base + slot;
        rows.out_ids[o] = id[k];
        rows.out_dists[o] = d[k];
        rows.out_acc[o] = ac[k];
        rows.out_evaluated[o] = ev[k];
      }
    }
  }
  // fresh word i of run r: slot i + the list's and the other runs' words
  // below it
  for (int j = tid; j < n; j += kRankThreads) {
    const int r = j / kRun, i = j % kRun;
    const u64 x = s_fresh[j];
    int slot = i + below(s_list, L, x);
    for (int r2 = 0; r2 < runs; ++r2) {
      if (r2 != r)
        slot += below(s_fresh + r2 * kRun, min(kRun, n - r2 * kRun), x);
    }
    if (slot < L) {
      const size_t src = fbase + (position(x) - L);
      const size_t o = base + slot;
      rows.out_ids[o] = rows.n_ids[src];
      rows.out_dists[o] = rows.n_dists[src];
      rows.out_acc[o] = INFINITY;
      rows.out_evaluated[o] = 0;
    }
  }
}

__global__ void block_sort_kernel(SortRows rows) {
  extern __shared__ u64 s_row[];
  const int row = blockIdx.x, P = rows.P;
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    s_row[i] = rows.load(row, i);
  __syncthreads();
  const int half = P >> 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const u64 x = s_row[lo], y = s_row[lo + j];
        if ((x > y) == ((lo & k) == 0)) {
          s_row[lo] = y;
          s_row[lo + j] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    rows.store(row, i, position(s_row[i]));
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Let ``kernel`` take ``smem`` bytes of dynamic shared memory.
int allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Sort Q rows of P (a power of two) in shared memory, one block per row.
int block_sort(const SortRows& rows, int Q, cudaStream_t st) {
  const int P = rows.P;
  const size_t smem = sizeof(u64) * P;
  if (const int err = allow_smem(
          reinterpret_cast<const void*>(&block_sort_kernel), smem))
    return err;
  const int threads = P / 2 < 1024 ? P / 2 : 1024;
  block_sort_kernel<<<Q, threads, smem, st>>>(rows);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kWarpThreads = 32 * kWarpRows;

int warp_blocks(int Q) { return (Q + kWarpRows - 1) / kWarpRows; }

template <int E>
void launch_sort(const SortRows& rows, int Q, cudaStream_t st) {
  warp_sort_kernel<E><<<warp_blocks(Q), kWarpThreads, 0, st>>>(rows, Q);
}

template <int F>
int launch_rank(const MergeRows& rows, int Q, int runs, cudaStream_t st) {
  const size_t smem = sizeof(u64) * (rows.L + runs * 32 * F);
  if (const int err = allow_smem(
          reinterpret_cast<const void*>(&rank_merge_kernel<F>), smem))
    return err;
  rank_merge_kernel<F><<<Q, kRankThreads, smem, st>>>(rows);
  return static_cast<int>(cudaGetLastError());
}

// The rank merge: fresh words in runs of next_pow2(n) >= 32 slots, or of
// 1024 above that.
int rank_merge(const MergeRows& rows, int Q, cudaStream_t st) {
  const int n = rows.n;
  const int run = n > kWarpMax ? kWarpMax : pow2_at_least(n < 32 ? 32 : n);
  const int runs = (n + run - 1) / run;
  switch (run / 32) {
    case 1: return launch_rank<1>(rows, Q, runs, st);
    case 2: return launch_rank<2>(rows, Q, runs, st);
    case 4: return launch_rank<4>(rows, Q, runs, st);
    case 8: return launch_rank<8>(rows, Q, runs, st);
    case 16: return launch_rank<16>(rows, Q, runs, st);
    default: return launch_rank<32>(rows, Q, runs, st);
  }
}

template <int E, int F>
void launch_merge(const MergeRows& rows, int Q, cudaStream_t st) {
  if constexpr (2 * F <= E)
    warp_merge_kernel<E, F><<<warp_blocks(Q), kWarpThreads, 0, st>>>(rows, Q);
}

// The merge kernel for E elements a lane, F of them fresh (F <= E / 2).
template <int E>
void launch_merge_slots(const MergeRows& rows, int Q, int F, cudaStream_t st) {
  switch (F) {
    case 1: launch_merge<E, 1>(rows, Q, st); break;
    case 2: launch_merge<E, 2>(rows, Q, st); break;
    case 4: launch_merge<E, 4>(rows, Q, st); break;
    case 8: launch_merge<E, 8>(rows, Q, st); break;
    case 16: launch_merge<E, 16>(rows, Q, st); break;
  }
}

}  // namespace

extern "C" int bitonic_sort_launch(const void* keys, const void* vals,
                                   void* out_keys, void* out_vals, int Q, int P,
                                   void* stream) {
  if (Q == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SortRows rows{static_cast<const float*>(keys),
                      static_cast<const int32_t*>(vals),
                      static_cast<float*>(out_keys),
                      static_cast<int32_t*>(out_vals), P};
  if (P > kWarpMax) return block_sort(rows, Q, st);
  switch (P <= 32 ? 1 : P / 32) {
    case 1: launch_sort<1>(rows, Q, st); break;
    case 2: launch_sort<2>(rows, Q, st); break;
    case 4: launch_sort<4>(rows, Q, st); break;
    case 8: launch_sort<8>(rows, Q, st); break;
    case 16: launch_sort<16>(rows, Q, st); break;
    case 32: launch_sort<32>(rows, Q, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitonic_merge_launch(const void* ids, const void* dists,
                                    const void* acc, const void* evaluated,
                                    const void* n_ids, const void* n_dists,
                                    void* out_ids, void* out_dists,
                                    void* out_acc, void* out_evaluated, int Q,
                                    int L, int n, void* stream) {
  if (Q == 0 || L == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MergeRows rows{static_cast<const int32_t*>(ids),
                       static_cast<const float*>(dists),
                       static_cast<const float*>(acc),
                       static_cast<const uint8_t*>(evaluated),
                       static_cast<const int32_t*>(n_ids),
                       static_cast<const float*>(n_dists),
                       static_cast<int32_t*>(out_ids),
                       static_cast<float*>(out_dists),
                       static_cast<float*>(out_acc),
                       static_cast<uint8_t*>(out_evaluated), L, n};
  // fresh slots: next_pow2(n), at least one slot; the list fits before them
  const int fresh = pow2_at_least(n < 32 ? 32 : n);
  const int P = pow2_at_least(L + fresh);
  if (P > kWarpMax || L >= BITONIC_RANK_FROM) return rank_merge(rows, Q, st);
  switch (P / 32) {
    case 2: launch_merge_slots<2>(rows, Q, fresh / 32, st); break;
    case 4: launch_merge_slots<4>(rows, Q, fresh / 32, st); break;
    case 8: launch_merge_slots<8>(rows, Q, fresh / 32, st); break;
    case 16: launch_merge_slots<16>(rows, Q, fresh / 32, st); break;
    case 32: launch_merge_slots<32>(rows, Q, fresh / 32, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
