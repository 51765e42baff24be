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
// * Longer rows (up to 16384) sort in one block over shared memory, one
//   barrier per stage, with the pair index computed by shifts and masks; the
//   merge then sorts the whole row and needs no sorted list.
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
  __device__ int width() const { return P; }
  __device__ int kept() const { return P; }
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
  __device__ int width() const { return L + n; }
  __device__ int kept() const { return L; }
  __device__ u64 load_list(int row, int i) const {
    return pack(dists[(size_t)row * L + i], i);
  }
  __device__ u64 load_fresh(int row, int j) const {
    return pack(n_dists[(size_t)row * n + j], L + j);
  }
  __device__ u64 load(int row, int i) const {
    return i < L ? load_list(row, i) : load_fresh(row, i - L);
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

template <class Rows>
__global__ void block_sort_kernel(Rows rows, int P) {
  extern __shared__ u64 s_row[];
  const int row = blockIdx.x, w = rows.width();
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    s_row[i] = i < w ? rows.load(row, i) : kPad;
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
  for (int i = threadIdx.x; i < rows.kept(); i += blockDim.x)
    rows.store(row, i, position(s_row[i]));
}

// Sort Q rows padded to P (a power of two >= rows.width()) in shared
// memory, one block per row.
template <class Rows>
int block_sort(const Rows& rows, int Q, int P, cudaStream_t st) {
  const size_t smem = sizeof(u64) * P;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&block_sort_kernel<Rows>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = P / 2 < 1024 ? P / 2 : 1024;
  block_sort_kernel<Rows><<<Q, threads, smem, st>>>(rows, P);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kWarpThreads = 32 * kWarpRows;

int warp_blocks(int Q) { return (Q + kWarpRows - 1) / kWarpRows; }

template <int E>
void launch_sort(const SortRows& rows, int Q, cudaStream_t st) {
  warp_sort_kernel<E><<<warp_blocks(Q), kWarpThreads, 0, st>>>(rows, Q);
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

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
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
  if (P > kWarpMax) return block_sort(rows, Q, P, st);
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
  if (P > kWarpMax) return block_sort(rows, Q, pow2_at_least(L + n), st);
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
