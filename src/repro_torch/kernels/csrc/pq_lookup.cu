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
// Three entry points:
//   pq_lookup_launch         (N, M) u8 codes, one (M, C) ADT -> (N,)
//                            (the reference signature, kept for parity);
//   pq_lookup_gather_launch  (Q, n) i32 ids, (N_base, M) u8 code table,
//                            (Q, M, C) ADTs, an optional (Q, n) bool mask ->
//                            (Q, n).  A pair whose mask is false reads no code
//                            and no ADT entry and gets +inf.  The search uses
//                            this one, with its "fresh" mask.
//   pq_lookup_lists_launch   (Q, P) i32 probed lists, (nlist,) i32 lengths,
//                            (nlist, max_len, M) u8 list codes, (A, M, C)
//                            ADTs (A = Q*P, one a probe, or A = Q, one a
//                            query shared by its P probes) -> (Q, P,
//                            max_len), +inf at each slot >= the list's
//                            length.  IVF's search uses this one.
// Bound of the first two: bytes — per scored row its id, its M code bytes
// and M ADT entries — and, at a round's small Q*n, the latency of the
// dependent id -> code -> ADT loads, which the one-warp-per-row layout keeps
// to three.  An id outside [0, N_base), masked or not, or a code >= C traps:
// a raw pointer does not wrap, and a wild read would return a silently wrong
// distance.
//
// The lists entry scores each probe's list as the reference does (one
// pq_lookup a probed list against that probe's ADT), the shape a Hopper
// block wants: one ADT in shared memory and a contiguous run of code rows.
// A block takes one probe and a tile of kListRows rows of its list (the
// tiles of a probe are neighbouring blocks, so its ADT is read from device
// memory once and from L2 after).  It stages the (M, C) ADT in shared memory
// with 16-byte loads (32 KB at 32 x 256), then each thread scores rows of
// the run: the row's M code bytes as 16-byte loads (M % 16 == 0; bytes
// otherwise) and M shared-memory entries summed in ascending m; a warp
// writes 32 consecutive outputs.  A tile wholly past the list's length reads
// nothing and writes +inf.  C = 256 has its own instantiation: no code can
// be out of range, and the ADT rows' offsets are immediates.  Bound: bytes
// — the ADTs once, each probed list's code rows (from L2 after the first
// probe of a list: all the lists of a 1M-row index are 34.5 MB) and the
// (Q, P, max_len) output.  What holds it instead: the instructions of a
// lookup (byte extract, shared load, add) and the bank conflicts of a
// warp's 32 shared loads of one subspace, whose banks the random codes pick
// (scripts/kernel_variants.py times the same rows with conflict-free codes;
// PERF.md).  A probe outside [0, nlist), a length outside [0, max_len] or a
// code >= C traps.
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

#ifndef PQ_LOOKUP_LISTS_ROWS
#define PQ_LOOKUP_LISTS_ROWS 4096
#endif
constexpr int kListThreads = 256;
constexpr int kListRows = PQ_LOOKUP_LISTS_ROWS;  // rows a block: one staging

// acc + the ADT entries of the four codes packed in ``word`` (byte b is
// subspace b of ``adt``, whose rows are C apart), in ascending subspace
// order.  kC = 256: every byte is a valid code, and the row offsets are
// immediates; kC = 0: a runtime C, ``bad`` records a code >= C (clamped,
// then trapped by the caller).
template <int kC>
__device__ __forceinline__ float add_codes(float acc, unsigned word,
                                           const float* adt, int C,
                                           bool& bad) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int code = (word >> (8 * b)) & 0xff;
    if constexpr (kC == 256) {
      acc += adt[b * 256 + code];
    } else {
      bad |= code >= C;
      acc += adt[b * C + min(code, C - 1)];
    }
  }
  return acc;
}

// kC: 256, or 0 for any other C (read at run time).  kVec: M % 16 == 0 and
// the codes 16-byte aligned, so a row is read as 16-byte words.
template <int kC, bool kVec>
__global__ void __launch_bounds__(kListThreads)
pq_lookup_lists_kernel(const int32_t* __restrict__ probes,
                       const int32_t* __restrict__ lengths,
                       const uint8_t* __restrict__ codes,
                       const float* __restrict__ adts,
                       float* __restrict__ out, int nlist, int max_len,
                       int M, int C_rt, int tiles, int adt_div) {
  extern __shared__ float adt_s[];                 // [M][C]
  const int C = kC > 0 ? kC : C_rt;
  const int probe = blockIdx.x / tiles;            // index into (Q, P)
  const int r0 = (blockIdx.x - probe * tiles) * kListRows;
  const int r1 = min(r0 + kListRows, max_len);
  const int list = __ldg(probes + probe);
  if (list < 0 || list >= nlist) __trap();
  const int len = __ldg(lengths + list);
  if (len < 0 || len > max_len) __trap();
  float* orow = out + static_cast<size_t>(probe) * max_len;
  if (r0 >= len) {                                 // uniform across the block
    for (int r = r0 + threadIdx.x; r < r1; r += kListThreads) orow[r] = INFINITY;
    return;
  }
  const int mc = M * C;
  const float* adt = adts + static_cast<size_t>(probe / adt_div) * mc;
  if ((mc & 3) == 0 && (reinterpret_cast<uintptr_t>(adt) & 15) == 0) {
    const float4* a4 = reinterpret_cast<const float4*>(adt);
    float4* s4 = reinterpret_cast<float4*>(adt_s);
    for (int i = threadIdx.x; i < (mc >> 2); i += kListThreads) s4[i] = __ldg(a4 + i);
  } else {
    for (int i = threadIdx.x; i < mc; i += kListThreads) adt_s[i] = __ldg(adt + i);
  }
  __syncthreads();
  const uint8_t* lcodes = codes + static_cast<size_t>(list) * max_len * M;
  for (int r = r0 + threadIdx.x; r < r1; r += kListThreads) {
    if (r >= len) {
      orow[r] = INFINITY;
      continue;
    }
    const uint8_t* row = lcodes + r * M;          // max_len * M < 2^31
    float acc = 0.f;
    bool bad = false;
    if constexpr (kVec) {
      for (int m0 = 0; m0 < M; m0 += 16) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + m0));
        const float* a = adt_s + m0 * C;
        acc = add_codes<kC>(acc, w.x, a, C, bad);
        acc = add_codes<kC>(acc, w.y, a + 4 * C, C, bad);
        acc = add_codes<kC>(acc, w.z, a + 8 * C, C, bad);
        acc = add_codes<kC>(acc, w.w, a + 12 * C, C, bad);
      }
    } else {
      for (int m = 0; m < M; ++m) {
        const int code = __ldg(row + m);
        bad |= code >= C;
        acc += adt_s[m * C + min(code, C - 1)];
      }
    }
    if (bad) __trap();
    orow[r] = acc;
  }
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

extern "C" int pq_lookup_lists_launch(const void* probes, const void* lengths,
                                      const void* codes, const void* adts,
                                      void* out, int Q, int P, int nlist,
                                      int max_len, int M, int C, int A,
                                      void* stream) {
  if (Q == 0 || P == 0 || max_len == 0) return 0;
  if (A != Q * P && A != Q) return static_cast<int>(cudaErrorInvalidValue);
  // past the block's 227 KB, cudaFuncSetAttribute below returns the error
  const size_t smem = sizeof(float) * static_cast<size_t>(M) * C;
  const int tiles = (max_len + kListRows - 1) / kListRows;
  const size_t blocks = static_cast<size_t>(Q) * P * tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // A = Q*P: probe p reads ADT p; A = Q: probe p reads its query's, p / P
  const int adt_div = A == Q * P ? 1 : P;
  const bool vec = M % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  auto kernel = C == 256 ? (vec ? pq_lookup_lists_kernel<256, true>
                                : pq_lookup_lists_kernel<256, false>)
                         : (vec ? pq_lookup_lists_kernel<0, true>
                                : pq_lookup_lists_kernel<0, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kListThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(probes), static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(codes), static_cast<const float*>(adts),
      static_cast<float*>(out), nlist, max_len, M, C, tiles, adt_div);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
