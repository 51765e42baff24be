// Selective scan of the Mamba-2 blocks (zamba2) in its chunked matrix form
// (state-space duality, SSD), forward and backward, on the tensor cores.
//
// Replaces no Pallas kernel: it is the Mamba-2 (per-head decay) entry of
// the step kernels selective_scan.cu and selective_scan_bwd.cu, which port
// src/repro/models/ssm.py::selective_scan (a chunked associative scan in the
// reference) and its JAX gradient.  From h0, for each head (decay a, width
// HD = DI / NH) and step t:
//
//   h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) B_t^T,   y_t = h_t C_t
//
// with the state h (HD, DS), B and C (B, S, DS) shared by the heads, dt (B,
// S, NH).  Within a chunk of kQ steps, with la = dt a (<= 0), U = dt x (kQ,
// HD), G = C B^T (kQ, kQ) and the decays E[i, j] = exp(sum of la over j < k
// <= i) (j <= i), exp(Lp_i) (k <= i), exp(Ls_j) (k > j), exp(Ltot):
//
//   Y = (G o E) U + exp(Lp) o C H^T,   H <- exp(Ltot) H + (exp(Ls) o U)^T B
//
// so a chunk is four products of 64 x 64 x 64 and only H passes from chunk
// to chunk.  The backward runs the same products in reverse (plain version
// and formulas: kernels/selective_scan.py selective_scan_ssd_bwd_plain).
//
// Bound (H100 SXM): at zamba2's widths (HD = DS = 64) the bytes at 3.35
// TB/s, forward (x and y) and backward (inputs, cotangents, gradients):
// the function's products, each once at 495 TFLOP/s TF32, take a quarter
// to a half of that.  These kernels' own three-pass products (the
// backward forming G once per 8 heads) take 0.8x the forward's bytes time
// and 1.5x the backward's, a floor of this design.  On the H100 both run
// at several times their bound (PERF.md).  What holds them (estimates: the card gives
// no counters): half the time is the mma.sync products, whose fragments
// are loaded from shared memory and split a product at a time, several
// issue slots each; at one or two blocks an SM little hides the latency
// of those, of the barriers and of the copies.  wgmma, with its operands
// split once into shared memory, is the next step.
//
// Precision: every product runs as three TF32 products, hi.hi + hi.lo +
// lo.hi with hi = v rounded to TF32 and lo = v - hi (truncated to TF32 by
// the tensor cores), accumulated in float32: one pass keeps ~3 decimal
// digits and misses the 1e-5 bar (5e-4 on the CPU blueprint), three keep
// ~21 bits.  No exponent is a difference of prefix sums (L_i - L_j loses
// the digits of L_i, ~1e-5 at |L| ~ 150): each is summed directly from
// 8-step block sums, all terms of one sign, and a decay across blocks is a
// product of their exps.  Nothing is divided by a decay.  The log-decays'
// cotangent (row minus column sums that cancel) is summed in float64.
//
// Design:
//  * ssd_gram then ssd_chunk_scan, the forward (y, h_last): G = C B^T once
//    a (chunk, batch row) for every head, into the caller's workspace; a
//    block of 8 warps per (head, batch row) walks the chunks in order with
//    the state in registers (each warp a 16 x 32 tile of the 64 x 64
//    products, mma.sync m16n8k8), G copied in with the chunk's tiles.  One block a (b, head) since the state is the only
//    thing carried: the chunks of a block run in order, so no second pass
//    carries states (which would write and read them: as many bytes again
//    as x).  It holds one stage of x, B, C and dt tiles (92 KB) so that two
//    blocks share an SM, the next chunk's copies (cp.async) landing while
//    the other block computes;
//  * ssd_state_walks, the backward's two walks in one launch (they read
//    only inputs, so their 2 B NH blocks share the card; two stages each):
//    the state entering each chunk, stored (B, nc, NH, HD, DS), and in
//    reverse dH <- exp(Ltot) dH + (exp(Lp) o dY)^T C, the state's
//    cotangent leaving each chunk, stored the same way, and dh0;
//  * ssd_chunk_grads: a block per (group of kGroup heads, chunk, batch row),
//    all in parallel: G once, then for each head in order dM = dY U^T, dU,
//    dC, dB and the log-decays' cotangent; the next head's tiles copied
//    while this one computes; dB and dC summed over the group's heads in
//    registers, in order;
//  * ssd_grads_reduce sums the groups' dB and dC and the chunks' da in a
//    fixed order.  No float atomics: two runs give the same bits.
// HD and DS are multiples of 8 up to 64 (padded to 64 in shared memory with
// zeros); S is any length (the last chunk's rows past S are zeros, dt = 0:
// no decay, no input).  Dynamic shared memory above 48 KB is set with
// cudaFuncSetAttribute.  The backward's workspace
// (selective_scan_ssd_bwd_workspace floats) is the caller's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;          // steps a chunk
constexpr int kW = 64;          // the widest head and state
constexpr int kThreads = 256;   // 8 warps, a 16 x 32 output tile each
constexpr int kLd = 68;         // shared row strides (floats): a fragment
constexpr int kLdT = 72;        // reading along rows wants 68, down columns 72
constexpr int kGroup = 8;       // the backward's heads a block
constexpr unsigned kFull = 0xffffffffu;

// ---- PTX and launch primitives ----------------------------------------------

// d += a b, a (16 x 8, row) and b (8 x 8, col) in TF32, d float32 (not
// volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, zeros when !in (src unread)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every copy group but the newest has landed (this thread's)
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<float*>(smem4);
}

template <class... P, class... A>
cudaError_t launch_kernel(void (*kernel)(P...), dim3 grid, size_t smem,
                          cudaStream_t stream, A... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// ---- end of primitives -------------------------------------------------------

// hi = v rounded to TF32 (10 mantissa bits, ties away from zero: integer
// operations, a quarter the cost of cvt.rna, whose rate is 16 a clock an
// SM); lo = v - hi, exact in float32, handed over whole: the tensor cores
// read a TF32 operand's top 19 bits and drop the rest
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A warp's place: lane (g = lane / 4, t = lane % 4) and its output tile,
// rows r0..r0+15, columns c0..c0+31: four m16n8 tiles, whose element e of
// tile j sits at row r0 + g + 8 (e / 2), column c0 + 8 j + 2 t + e % 2.
struct Warp {
  int warp, g, t, r0, c0;
  __device__ Warp() {
    warp = threadIdx.x >> 5;
    g = (threadIdx.x & 31) >> 2;
    t = threadIdx.x & 3;
    r0 = (warp & 3) * 16;
    c0 = (warp >> 2) * 32;
  }
  __device__ int row(int e) const { return r0 + g + 8 * (e >> 1); }
  __device__ int col(int j, int e) const {
    return c0 + 8 * j + 2 * t + (e & 1);
  }
  // whole tile above the diagonal (every column > every row)
  __device__ bool upper() const { return c0 > r0 + 15; }
};

using Acc = float[4][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
}

// one k-step (8 columns from k) of acc += A B on the warp's tile, each
// product in three TF32 passes: hi.hi into acc, the two small ones into
// `small`.  The passes run tile after tile, so consecutive mma.sync never
// wait on one another: 8 accumulators in flight a warp
template <class FA, class FB>
__device__ __forceinline__ void mma3_step(Acc& acc, Acc& small, const Warp& w,
                                          int k, FA& A, FB& B) {
  uint32_t ah[4], al[4], bh[4][2], bl[4][2];
  split(A(w.r0 + w.g, k + w.t), ah[0], al[0]);
  split(A(w.r0 + w.g + 8, k + w.t), ah[1], al[1]);
  split(A(w.r0 + w.g, k + w.t + 4), ah[2], al[2]);
  split(A(w.r0 + w.g + 8, k + w.t + 4), ah[3], al[3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = w.c0 + 8 * j + w.g;
    split(B(k + w.t, n), bh[j][0], bl[j][0]);
    split(B(k + w.t + 4, n), bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(small[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bh[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(small[j], ah, bl[j]);
}

__device__ __forceinline__ void add(Acc& acc, const Acc& small) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
  }
}

// acc += sum over k0 <= k < k1 (multiples of 8) of A(m, k) B(k, n)
template <class FA, class FB>
__device__ __forceinline__ void mma3(Acc& acc, const Warp& w, int k0, int k1,
                                     FA A, FB B) {
  Acc small;
  zero(small);
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) mma3_step(acc, small, w, k, A, B);
  add(acc, small);
}

// the same over every k < kW, unrolled whole: a width below kW reads the
// tiles' zero padding
template <class FA, class FB>
__device__ __forceinline__ void mma3_all(Acc& acc, const Warp& w, FA A,
                                         FB B) {
  Acc small;
  zero(small);
#pragma unroll
  for (int k = 0; k < kW; k += 8) mma3_step(acc, small, w, k, A, B);
  add(acc, small);
}

// A chunk's decays for one head (shared memory).  Every sum has terms of
// one sign (la <= 0) and is taken directly; a decay across 8-blocks is the
// product of three exps of such sums (each <= 1), within one the exp of
// its own sum, so the (i, j) decays cost a load or two each.
struct Decay {
  float pre[kQ];      // la over the step's 8-block up to it, inclusive
  float suf[kQ];      // la over the rest of its 8-block, after it
  float tot[8];       // each 8-block's sum
  float ep[kQ];       // exp(pre)
  float es[kQ];       // exp(suf)
  float espan[9][9];  // exp(tot[b1] + ... + tot[b2 - 1])
  float inblk[kQ][8]; // [i][o]: exp(la over 8 (i / 8) + o < k <= i)
  float elp[kQ];      // exp(sum over k <= i)
  float els[kQ];      // exp(sum over k > j)
  float eltot;        // exp(sum over the chunk)
  float pad[2];
};
static_assert(sizeof(Decay) % 16 == 0, "Decay keeps 16-byte alignment");

// la summed over lo <= k <= hi (within one 8-block or over the 8 block
// sums), in index order: unrolled, the terms outside [lo, hi] masked to 0,
// so the loads issue together
__device__ __forceinline__ float sum8(const float* v, float scale, int base,
                                      int lo, int hi) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = base + k;
    s += (i >= lo && i <= hi) ? v[i] * scale : 0.f;
  }
  return s;
}

// fills d from the chunk's dt (zeros past S) and the head's a (with kPairs
// the (i, j) decays' tables too: ep, es, espan, inblk); two barriers
template <bool kPairs>
__device__ void decays(Decay& d, const float* dts, float a) {
  const int tid = threadIdx.x;
  if (tid < kQ) {
    const float s = sum8(dts, a, tid & ~7, tid & ~7, tid);
    d.pre[tid] = s;
    if (kPairs) d.ep[tid] = expf(s);
  } else if (tid < 2 * kQ) {
    const int j = tid - kQ;
    const float s = sum8(dts, a, j & ~7, j + 1, j | 7);
    d.suf[j] = s;
    if (kPairs) d.es[j] = expf(s);
  } else if (tid < 2 * kQ + 8) {
    const int blk = tid - 2 * kQ;
    d.tot[blk] = sum8(dts, a, 8 * blk, 8 * blk, 8 * blk + 7);
  }
  if (kPairs) {
    for (int q = tid; q < kQ * 8; q += kThreads) {  // within 8-blocks
      const int i = q >> 3, o = q & 7;
      const float s = sum8(dts, a, i & ~7, (i & ~7) + o + 1, i);
      d.inblk[i][o] = o <= (i & 7) ? expf(s) : 0.f;
    }
  }
  __syncthreads();
  if (tid < 81) {
    if (kPairs) d.espan[tid / 9][tid % 9] = expf(
        sum8(d.tot, 1.f, 0, tid / 9, tid % 9 - 1));
  } else if (tid >= 128 && tid < 128 + kQ) {
    const int i = tid - 128;
    d.elp[i] = expf(sum8(d.tot, 1.f, 0, 0, (i >> 3) - 1) + d.pre[i]);
  } else if (tid >= 192) {
    const int j = tid - 192;
    d.els[j] = expf(d.suf[j] + sum8(d.tot, 1.f, 0, (j >> 3) + 1, 7));
  } else if (tid == 81) {
    d.eltot = expf(sum8(d.tot, 1.f, 0, 0, 7));
  }
  __syncthreads();
}

// E[i, j] for j <= i: exp of la summed over j < k <= i
__device__ __forceinline__ float decay_ij(const Decay& d, int i, int j) {
  const int bi = i >> 3, bj = j >> 3;
  return bi == bj ? d.inblk[i][j & 7]
                  : d.es[j] * d.espan[bj + 1][bi] * d.ep[i];
}

// a (kQ or kW) x 64 tile of rows of width `width` (a multiple of 8), row r
// of the source at src + r * stride, into shared memory with row stride ld;
// rows >= rows and columns >= width are zeros
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src,
                                          size_t stride, int rows, int width) {
  for (int q = threadIdx.x; q < kQ * (kW / 4); q += kThreads) {
    const int r = q >> 4, c4 = (q & 15) * 4;
    const bool in = r < rows && c4 < width;
    cp_async16(dst + r * ld + c4, in ? src + r * stride + c4 : src, in);
  }
}

enum Mode { kOut = 0, kStates = 1, kGradStates = 2 };

// the forward holds one stage of tiles, so two blocks share an SM and one
// computes while the other's next tiles land; the state walks hold two
template <int kMode>
__host__ __device__ constexpr int scan_stages() {
  return kMode == kOut ? 1 : 2;
}

template <int kMode>
constexpr size_t scan_smem_floats() {
  return scan_stages<kMode>()
             * (kQ * kLdT + kQ * kLd + (kMode == kOut ? kQ * kLd : 0) + kQ)
         + (kMode == kOut ? 2 * kQ * kLd : 0) + sizeof(Decay) / 4;
}

// The chunk walk of one (head, batch row) = (blockIdx.x, blockIdx.y); the
// state (rows p < HD, columns n < DS) is a warp tile in registers.
//  kOut:        xin = x, zin = B, cg = C, gram = G a chunk (ssd_gram's),
//               hin = h0 -> y, hout = h_last;
//  kStates:     xin = x, zin = B, hin = h0 -> states[b, c] = the state
//               entering chunk c;
//  kGradStates: xin = gy, zin = C, hin = gh_last, chunks in reverse ->
//               states[b, c] = the state's cotangent leaving chunk c, hout =
//               dh0.
template <int kMode>
__device__ __forceinline__ void chunk_scan(
    const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ xin, const float* __restrict__ zin,
    const float* __restrict__ cg, const float* __restrict__ gram,
    const float* __restrict__ hin, float* __restrict__ y,
    float* __restrict__ hout, float* __restrict__ states, int S, int NH,
    int HD, int DS) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int DI = NH * HD, nc = (S + kQ - 1) / kQ;
  const float ah = a[h];
  const Warp w;
  constexpr int kStages = scan_stages<kMode>();
  // a stage's tiles: stage st at stage0 + st * kStageFloats
  constexpr int kStageFloats =
      kQ * kLdT + kQ * kLd + (kMode == kOut ? kQ * kLd : 0) + kQ;
  float* sm = dynamic_smem();
  float* stage0 = sm;
  sm += kStages * kStageFloats;
  auto xs = [&](int st) { return stage0 + st * kStageFloats; };
  auto zs = [&](int st) { return xs(st) + kQ * kLdT; };
  auto cs = [&](int st) { return zs(st) + kQ * kLd; };
  auto dts = [&](int st) {
    return cs(st) + (kMode == kOut ? kQ * kLd : 0);
  };
  float* ms = sm;                     // G, then G o E (kOut)
  float* hs = sm + kQ * kLd;          // the state entering the chunk (kOut)
  if (kMode == kOut) sm += 2 * kQ * kLd;
  Decay& dec = *reinterpret_cast<Decay*>(sm);

  auto chunk_at = [&](int it) {
    return kMode == kGradStates ? nc - 1 - it : it;
  };
  auto load = [&](int it, int st) {
    const int t0 = chunk_at(it) * kQ, nv = min(kQ, S - t0);
    const size_t row0 = (size_t)b * S + t0;
    copy_tile(xs(st), kLdT, xin + row0 * DI + (size_t)h * HD, DI, nv, HD);
    copy_tile(zs(st), kLd, zin + row0 * DS, DS, nv, DS);
    if (kMode == kOut) {
      copy_tile(cs(st), kLd, cg + row0 * DS, DS, nv, DS);
      copy_tile(ms, kLd, gram + ((size_t)b * nc + chunk_at(it)) * kQ * kQ,
                kQ, kQ, kQ);
    }
    if (tid < kQ) {
      const bool in = tid < nv;
      cp_async4(dts(st) + tid, in ? dt + (row0 + tid) * NH + h : dt, in);
    }
    cp_async_commit();
  };

  // the state (or its cotangent), a warp tile in registers
  Acc hacc;
  const float* hsrc = hin + ((size_t)b * DI + (size_t)h * HD) * DS;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = w.row(e), n = w.col(j, e);
      hacc[j][e] = (p < HD && n < DS) ? hsrc[(size_t)p * DS + n] : 0.f;
      if (kMode == kOut) hs[p * kLd + n] = hacc[j][e];
    }
  }
  load(0, 0);
  for (int it = 0; it < nc; ++it) {
    const int st = kStages == 2 ? it & 1 : 0, c = chunk_at(it), t0 = c * kQ;
    const int nv = min(kQ, S - t0);
    if (kStages == 2 && it + 1 < nc) {
      load(it + 1, st ^ 1);
      cp_async_wait_prev();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();                    // this chunk's tiles (and hs) are in
    float* xt = xs(st);
    const float* zt = zs(st);
    const float* ct = cs(st);
    const float* dtt = dts(st);
    if (kMode != kGradStates) {         // x -> U = dt x, in place
      for (int q = tid; q < kQ * kW; q += kThreads) {
        xt[(q >> 6) * kLdT + (q & 63)] *= dtt[q >> 6];
      }
    }
    decays<kMode == kOut>(dec, dtt, ah);
    if (kMode != kOut) {
      float* dst = states + (((size_t)b * nc + c) * NH + h) * HD * DS;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int p = w.row(e), n = w.col(j, e);
          if (p < HD && n < DS) {
            *reinterpret_cast<float2*>(dst + (size_t)p * DS + n) =
                make_float2(hacc[j][e], hacc[j][e + 1]);
          }
        }
      }
    }
    if (kMode == kOut) {
      // M = G o E in place, each element by the thread of its warp tile
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = w.row(e), jj = w.col(j, e);
          float& m = ms[i * kLd + jj];
          m = jj <= i ? m * decay_ij(dec, i, jj) : 0.f;
        }
      }
      __syncthreads();                  // ms is whole
      // Y = exp(Lp) o C H^T + M U
      Acc yacc;
      zero(yacc);
      mma3_all(yacc, w,
           [&](int i, int n) { return ct[i * kLd + n]; },
           [&](int n, int p) { return hs[p * kLd + n]; });
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] *= dec.elp[w.row(e)];
      }
      mma3(yacc, w, 0, w.r0 + 16,
           [&](int i, int jj) { return ms[i * kLd + jj]; },
           [&](int jj, int p) { return xt[jj * kLdT + p]; });
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int i = w.row(e), p = w.col(j, e);
          if (i < nv && p < HD) {
            *reinterpret_cast<float2*>(
                y + ((size_t)b * S + t0 + i) * DI + (size_t)h * HD + p) =
                make_float2(yacc[j][e], yacc[j][e + 1]);
          }
        }
      }
    }
    // the state: H <- exp(Ltot) H + (w o X)^T Z, w = exp(Ls) and X = U
    // forward, w = exp(Lp) and X = dY in reverse
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[j][e] *= dec.eltot;
    }
    mma3_all(hacc, w,
         [&](int p, int k) {
           return (kMode == kGradStates ? dec.elp[k] : dec.els[k])
                  * xt[k * kLdT + p];
         },
         [&](int k, int n) { return zt[k * kLd + n]; });
    __syncthreads();                    // this stage, ms and hs are read
    if (kStages == 1 && it + 1 < nc) load(it + 1, 0);
    if (kMode == kOut) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hs[w.row(e) * kLd + w.col(j, e)] = hacc[j][e];
        }
      }
    }
  }
  if (kMode != kStates) {
    float* dst = hout + ((size_t)b * DI + (size_t)h * HD) * DS;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int p = w.row(e), n = w.col(j, e);
        if (p < HD && n < DS) {
          *reinterpret_cast<float2*>(dst + (size_t)p * DS + n) =
              make_float2(hacc[j][e], hacc[j][e + 1]);
        }
      }
    }
  }
}

// G = C B^T of each (chunk, batch row) = (blockIdx.x, blockIdx.y), the
// forward's product that every head shares, once for all of them: gram
// (B, nc, kQ, kQ), rows and columns past S zeros, above the diagonal zeros
__global__ void __launch_bounds__(kThreads)
ssd_gram(const float* __restrict__ bg, const float* __restrict__ cg,
         float* __restrict__ gram, int S, int DS) {
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int nv = min(kQ, S - c * kQ);
  const size_t row0 = (size_t)b * S + c * kQ;
  const Warp w;
  float* bs = dynamic_smem();
  float* cs = bs + kQ * kLd;
  copy_tile(bs, kLd, bg + row0 * DS, DS, nv, DS);
  copy_tile(cs, kLd, cg + row0 * DS, DS, nv, DS);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  Acc gacc;
  zero(gacc);
  if (!w.upper()) {
    mma3_all(gacc, w,
             [&](int i, int n) { return cs[i * kLd + n]; },
             [&](int n, int j) { return bs[j * kLd + n]; });
  }
  float* out = gram + ((size_t)b * nc + c) * kQ * kQ;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      *reinterpret_cast<float2*>(out + w.row(e) * kQ + w.col(j, e)) =
          make_float2(gacc[j][e], gacc[j][e + 1]);
    }
  }
}

// the forward: y and h_last, from ssd_gram's G
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_scan(const float* __restrict__ dt, const float* __restrict__ a,
               const float* __restrict__ x, const float* __restrict__ bg,
               const float* __restrict__ cg, const float* __restrict__ gram,
               const float* __restrict__ h0, float* __restrict__ y,
               float* __restrict__ h_last, int S, int NH, int HD, int DS) {
  chunk_scan<kOut>(dt, a, x, bg, cg, gram, h0, y, h_last, nullptr, S, NH,
                   HD, DS);
}

// the backward's two state walks at once, blockIdx.z = 0 the states (from
// x, B, h0), 1 their cotangents (from gy, C, gh_last, in reverse; and dh0):
// they depend on the inputs only, so their blocks share the card
__global__ void __launch_bounds__(kThreads, 2)
ssd_state_walks(const float* __restrict__ dt, const float* __restrict__ a,
                const float* __restrict__ x, const float* __restrict__ bg,
                const float* __restrict__ h0, const float* __restrict__ gy,
                const float* __restrict__ cg, const float* __restrict__ gh,
                float* __restrict__ dh0, float* __restrict__ states,
                float* __restrict__ gstates, int S, int NH, int HD, int DS) {
  if (blockIdx.z == 0) {
    chunk_scan<kStates>(dt, a, x, bg, nullptr, nullptr, h0, nullptr,
                        nullptr, states, S, NH, HD, DS);
  } else {
    chunk_scan<kGradStates>(dt, a, gy, cg, nullptr, nullptr, gh, nullptr,
                            dh0, gstates, S, NH, HD, DS);
  }
}

// sums over the quad of lanes that share a row (t = 0..3)
template <class T>
__device__ __forceinline__ T quad_sum(T v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v;
}

// sums over the lanes that share a column (g = 0..7)
template <class T>
__device__ __forceinline__ T column_sum(T v) {
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 8);
  v += __shfl_xor_sync(kFull, v, 16);
  return v;
}

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// doubles, then floats (tiles kept 16-byte aligned)
constexpr size_t grads_smem_bytes() {
  return sizeof(double) * (6 * kQ + 8)
         + sizeof(float) * (2 * kQ * kLd + 2 * kQ * kLdT
                            + 2 * (2 * kQ * kLd + kW * kLdT + kW * kLd + kQ)
                            + 6 * kQ)
         + sizeof(Decay);
}

// One (head group, chunk, batch row) = (blockIdx.x, .y, .z): the gradients
// of the chunk for the group's heads, in order, from the states of the two
// passes (H_prev = states, dH_next = gstates):
//   dM = dY U^T, M = G o E, dG = dM o E
//   dU = exp(Ls) o B dH^T + M^T dY -> dx = dU dt
//   dC += exp(Lp) o dY H + dG B,  dB += exp(Ls) o U dH + dG^T C
//   dla = reverse cumulative sum of rowsum(dM o M) - colsum(dM o M) + r - q
//         (+ exp(Ltot) <dH, H> + sum q at the chunk's end), in float64
//   ddt = dla a + <dU, x>;  da's partial = sum dla dt
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_grads(const float* __restrict__ dt, const float* __restrict__ a,
                const float* __restrict__ x, const float* __restrict__ bg,
                const float* __restrict__ cg, const float* __restrict__ gy,
                const float* __restrict__ states,
                const float* __restrict__ gstates, float* __restrict__ dx,
                float* __restrict__ ddt, float* __restrict__ dbp,
                float* __restrict__ dcp, float* __restrict__ dap, int S,
                int NH, int HD, int DS) {
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int NG = gridDim.x, nc = gridDim.y;
  const int DI = NH * HD, t0 = c * kQ, nv = min(kQ, S - t0);
  const int hlo = grp * kGroup, hhi = min(NH, hlo + kGroup);
  const size_t row0 = (size_t)b * S + t0;
  const Warp w;
  char* base = reinterpret_cast<char*>(dynamic_smem());
  double* rowp = reinterpret_cast<double*>(base);   // [2][kQ] by column half
  double* colp = rowp + 2 * kQ;                     // [4][kQ] by row quarter
  double* dotp = colp + 4 * kQ;                     // [8] by warp
  float* sm = reinterpret_cast<float*>(dotp + 8);
  float* bs = sm;
  sm += kQ * kLd;
  float* cs = sm;
  sm += kQ * kLdT;
  float* ms = sm;
  sm += kQ * kLdT;
  float* dgs = sm;
  sm += kQ * kLd;
  // a head's tiles, two stages: stage st at head0 + st * kHeadFloats
  constexpr int kHeadFloats = 2 * kQ * kLd + kW * kLdT + kW * kLd + kQ;
  float* head0 = sm;
  sm += 2 * kHeadFloats;
  auto xs = [&](int st) { return head0 + st * kHeadFloats; };
  auto ys = [&](int st) { return xs(st) + kQ * kLd; };
  auto hs = [&](int st) { return ys(st) + kQ * kLd; };
  auto dhs = [&](int st) { return hs(st) + kW * kLdT; };
  auto dts = [&](int st) { return dhs(st) + kW * kLd; };
  float* rp = sm;                 // [2][kQ]: r's partials by column half
  float* qp = rp + 2 * kQ;        // [2][kQ]: q's
  float* up = qp + 2 * kQ;        // [2][kQ]: <dU, x>'s
  Decay& dec = *reinterpret_cast<Decay*>(up + 2 * kQ);

  auto load_head = [&](int h, int st) {
    const size_t state = (((size_t)b * nc + c) * NH + h) * HD * DS;
    copy_tile(xs(st), kLd, x + row0 * DI + (size_t)h * HD, DI, nv, HD);
    copy_tile(ys(st), kLd, gy + row0 * DI + (size_t)h * HD, DI, nv, HD);
    copy_tile(hs(st), kLdT, states + state, DS, HD, DS);
    copy_tile(dhs(st), kLd, gstates + state, DS, HD, DS);
    if (tid < kQ) {
      const bool in = tid < nv;
      cp_async4(dts(st) + tid, in ? dt + (row0 + tid) * NH + h : dt, in);
    }
    cp_async_commit();
  };
  copy_tile(bs, kLd, bg + row0 * DS, DS, nv, DS);
  copy_tile(cs, kLdT, cg + row0 * DS, DS, nv, DS);
  load_head(hlo, 0);
  cp_async_wait_all();
  __syncthreads();
  Acc gacc, dbacc, dcacc;
  zero(gacc);
  zero(dbacc);
  zero(dcacc);
  if (!w.upper()) {
    mma3_all(gacc, w,
         [&](int i, int n) { return cs[i * kLdT + n]; },
         [&](int n, int j) { return bs[j * kLd + n]; });
  }
  const int half = w.warp >> 2, quarter = w.warp & 3;

  for (int h = hlo; h < hhi; ++h) {
    const int st = (h - hlo) & 1;
    if (h + 1 < hhi) {
      load_head(h + 1, st ^ 1);
      cp_async_wait_prev();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();                    // this head's tiles are in
    const float ah = a[h];
    const float* xt = xs(st);
    const float* yt = ys(st);
    const float* ht = hs(st);
    const float* dht = dhs(st);
    const float* dtt = dts(st);
    decays<true>(dec, dtt, ah);

    // dM = dY U^T on the warp's tile; M, dG; dM o M's row and column sums
    Acc acc;
    zero(acc);
    if (!w.upper()) {
      mma3_all(acc, w,
           [&](int i, int p) { return yt[i * kLd + p]; },
           [&](int p, int j) { return dtt[j] * xt[j * kLd + p]; });
    }
    double rsum[2] = {0.0, 0.0}, csum[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      csum[j][0] = csum[j][1] = 0.0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = w.row(e), jj = w.col(j, e);
        float m = 0.f, dg = 0.f;
        if (!w.upper() && jj <= i) {
          const float ed = decay_ij(dec, i, jj);
          m = gacc[j][e] * ed;
          dg = acc[j][e] * ed;
          const double pv = acc[j][e] * m;
          rsum[e >> 1] += pv;
          csum[j][e & 1] += pv;
        }
        ms[i * kLdT + jj] = m;
        dgs[i * kLd + jj] = dg;
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const double v = quad_sum(rsum[k]);
      if (w.t == 0) rowp[half * kQ + w.r0 + w.g + 8 * k] = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const double v = column_sum(csum[j][k]);
        if (w.g == 0) colp[quarter * kQ + w.c0 + 8 * j + 2 * w.t + k] = v;
      }
    }
    __syncthreads();                    // ms, dgs are whole

    // dU (rows j, columns p) -> dx; q and <dU, x> by row
    zero(acc);
    mma3_all(acc, w,
         [&](int j, int n) { return bs[j * kLd + n]; },
         [&](int n, int p) { return dht[p * kLd + n]; });
    float qv[2] = {0.f, 0.f}, uv[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w.row(e), p = w.col(j, e);
        acc[j][e] *= dec.els[r];
        qv[e >> 1] += (dtt[r] * xt[r * kLd + p]) * acc[j][e];
      }
    }
    mma3(acc, w, w.r0, kQ,
         [&](int j, int i) { return ms[i * kLdT + j]; },
         [&](int i, int p) { return yt[i * kLd + p]; });
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uv[e >> 1] += acc[j][e] * xt[w.row(e) * kLd + w.col(j, e)];
      }
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = w.row(e), p = w.col(j, e);
        if (r < nv && p < HD) {
          *reinterpret_cast<float2*>(
              dx + (row0 + r) * DI + (size_t)h * HD + p) =
              make_float2(acc[j][e] * dtt[r], acc[j][e + 1] * dtt[r]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float q = quad_sum(qv[k]), u = quad_sum(uv[k]);
      if (w.t == 0) {
        qp[half * kQ + w.r0 + w.g + 8 * k] = q;
        up[half * kQ + w.r0 + w.g + 8 * k] = u;
      }
    }

    // dC (rows i, columns n); r by row
    zero(acc);
    mma3_all(acc, w,
         [&](int i, int p) { return yt[i * kLd + p]; },
         [&](int p, int n) { return ht[p * kLdT + n]; });
    float rv[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w.row(e), n = w.col(j, e);
        acc[j][e] *= dec.elp[r];
        rv[e >> 1] += cs[r * kLdT + n] * acc[j][e];
      }
    }
    mma3(acc, w, 0, w.r0 + 16,
         [&](int i, int j) { return dgs[i * kLd + j]; },
         [&](int j, int n) { return bs[j * kLd + n]; });
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dcacc[j][e] += acc[j][e];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float r = quad_sum(rv[k]);
      if (w.t == 0) rp[half * kQ + w.r0 + w.g + 8 * k] = r;
    }

    // dB (rows j, columns n)
    zero(acc);
    mma3_all(acc, w,
         [&](int j, int p) { return dtt[j] * xt[j * kLd + p]; },
         [&](int p, int n) { return dht[p * kLd + n]; });
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= dec.els[w.row(e)];
    }
    mma3(acc, w, w.r0, kQ,
         [&](int j, int i) { return dgs[i * kLd + j]; },
         [&](int i, int n) { return cs[i * kLdT + n]; });
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dbacc[j][e] += acc[j][e];
    }

    // <dH, H>
    double dot = 0.0;
    for (int q = tid; q < HD * DS; q += kThreads) {
      const int p = q / DS, n = q % DS;
      dot += (double)(dht[p * kLd + n] * ht[p * kLdT + n]);
    }
    dot = warp_sum(dot);
    if (lane == 0) dotp[w.warp] = dot;
    __syncthreads();                    // every partial is in

    if (w.warp == 0) {
      // lane l holds steps 2 l and 2 l + 1
      double z[2], qsum = 0.0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s = 2 * lane + k;
        const double q = (double)qp[s] + (double)qp[kQ + s];
        z[k] = rowp[s] + rowp[kQ + s]
               - (colp[s] + colp[kQ + s] + colp[2 * kQ + s] + colp[3 * kQ + s])
               + ((double)rp[s] + (double)rp[kQ + s]) - q;
        qsum += q;
      }
      qsum = warp_sum(qsum);
      if (lane == 31) {
        double d = 0.0;
        for (int k = 0; k < 8; ++k) d += dotp[k];
        z[1] += (double)dec.eltot * d + qsum;
      }
      // suffix sums over the lanes' pairs
      double sfx = z[0] + z[1];
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_down_sync(kFull, sfx, off);
        if (lane + off < 32) sfx += o;
      }
      const float dla[2] = {(float)sfx, (float)(sfx - z[0])};
      double dsum = 0.0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s = 2 * lane + k;
        if (s < nv) {
          ddt[(row0 + s) * NH + h] = dla[k] * ah + (up[s] + up[kQ + s]);
        }
        dsum += (double)(dla[k] * dtt[s]);
      }
      dsum = warp_sum(dsum);
      if (lane == 0) dap[((size_t)b * nc + c) * NH + h] = (float)dsum;
    }
    __syncthreads();                    // the head's tiles and partials are read
  }

  float* dbo = dbp + (((size_t)b * NG + grp) * S + t0) * DS;
  float* dco = dcp + (((size_t)b * NG + grp) * S + t0) * DS;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = w.row(e), n = w.col(j, e);
      if (r < nv && n < DS) {
        *reinterpret_cast<float2*>(dbo + (size_t)r * DS + n) =
            make_float2(dbacc[j][e], dbacc[j][e + 1]);
        *reinterpret_cast<float2*>(dco + (size_t)r * DS + n) =
            make_float2(dcacc[j][e], dcacc[j][e + 1]);
      }
    }
  }
}

// dB and dC summed over the head groups, da over the rows and chunks, each
// in index order; a thread an output
__global__ void ssd_grads_reduce(const float* __restrict__ dbp,
                                 const float* __restrict__ dcp,
                                 const float* __restrict__ dap,
                                 float* __restrict__ db,
                                 float* __restrict__ dc,
                                 float* __restrict__ da, int B, int S,
                                 int DS, int NG, int nc, int NH) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_bc = (size_t)B * S * DS, per = (size_t)S * DS;
  if (i < 2 * n_bc) {
    const bool is_c = i >= n_bc;
    const size_t k = is_c ? i - n_bc : i;
    const size_t bi = k / per, ts = k % per;
    const float* p = (is_c ? dcp : dbp) + bi * NG * per + ts;
    float acc = 0.f;
    for (int g = 0; g < NG; ++g) acc += p[g * per];
    (is_c ? dc : db)[k] = acc;
  } else if (i < 2 * n_bc + NH) {
    const int h = (int)(i - 2 * n_bc);
    double acc = 0.0;
    for (int k = 0; k < B * nc; ++k) acc += dap[(size_t)k * NH + h];
    da[h] = (float)acc;
  }
}

bool takes(int B, int S, int NH, int HD, int DS) {
  return B > 0 && S > 0 && NH > 0 && HD > 0 && HD <= kW && HD % 8 == 0
         && DS > 0 && DS <= kW && DS % 8 == 0;
}

struct Work {              // the backward's workspace, carved (floats)
  float *states, *gstates, *dbp, *dcp, *dap;
};

Work carve(float* ws, int B, int S, int NH, int HD, int DS, size_t* total) {
  const size_t nc = (S + kQ - 1) / kQ, ng = (NH + kGroup - 1) / kGroup;
  const size_t n[5] = {B * nc * NH * HD * DS, B * nc * NH * HD * DS,
                       B * ng * S * DS, B * ng * S * DS, B * nc * NH};
  float* p[5];
  size_t off = 0;
  for (int k = 0; k < 5; ++k) {
    p[k] = ws ? ws + off : nullptr;
    off += (n[k] + 3) / 4 * 4;          // 16-byte aligned parts
  }
  if (total) *total = off;
  return Work{p[0], p[1], p[2], p[3], p[4]};
}

}  // namespace

// the forward's workspace, in floats: G a chunk (0: not taken)
extern "C" long long selective_scan_ssd_workspace(int B, int S, int NH,
                                                  int HD, int DS) {
  if (!takes(B, S, NH, HD, DS)) return 0;
  return (long long)B * ((S + kQ - 1) / kQ) * kQ * kQ;
}

// inputs as selective_scan_heads_launch's (selective_scan.cu): dt (B, S,
// NH), a (NH,), x (B, S, NH * HD), b and c (B, S, DS), h0 (B, NH * HD, DS);
// writes y and h_last; ws holds selective_scan_ssd_workspace floats.  Two
// launches: G a chunk, then the chunk walks.
extern "C" int selective_scan_ssd_launch(const void* dt, const void* a,
                                         const void* x, const void* b,
                                         const void* c, const void* h0,
                                         void* y, void* h_last, void* ws,
                                         int B, int S, int NH, int HD,
                                         int DS, void* stream) {
  if (!takes(B, S, NH, HD, DS)) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const int nc = (S + kQ - 1) / kQ;
  const cudaError_t err = launch_kernel(
      ssd_gram, dim3(nc, B), 2 * kQ * kLd * sizeof(float), st, f(b), f(c),
      static_cast<float*>(ws), S, DS);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_kernel(
      ssd_chunk_scan, dim3(NH, B), scan_smem_floats<kOut>() * sizeof(float),
      st, f(dt), f(a), f(x), f(b), f(c), f(ws), f(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), S, NH, HD, DS);
}

// the backward's workspace, in floats, for these sizes (0: not taken)
extern "C" long long selective_scan_ssd_bwd_workspace(int B, int S, int NH,
                                                      int HD, int DS) {
  if (!takes(B, S, NH, HD, DS)) return 0;
  size_t total = 0;
  carve(nullptr, B, S, NH, HD, DS, &total);
  return (long long)total;
}

// inputs as the forward's, gy and gh the cotangents of y and h_last; writes
// ddt, da, dx, db, dc, dh0 (each shaped as its input); ws holds
// selective_scan_ssd_bwd_workspace(B, S, NH, HD, DS) floats.  Three
// launches: the states and their cotangents, the chunks' gradients, the
// sums.
extern "C" int selective_scan_ssd_bwd_launch(
    const void* dt, const void* a, const void* x, const void* b,
    const void* c, const void* h0, const void* gy, const void* gh,
    void* ddt, void* da, void* dx, void* db, void* dc, void* dh0, void* ws,
    int B, int S, int NH, int HD, int DS, void* stream) {
  if (!takes(B, S, NH, HD, DS)) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Work wk = carve(m(ws), B, S, NH, HD, DS, nullptr);
  const int nc = (S + kQ - 1) / kQ, ng = (NH + kGroup - 1) / kGroup;
  static_assert(scan_smem_floats<kStates>()
                == scan_smem_floats<kGradStates>(), "one size for both walks");
  cudaError_t err = launch_kernel(
      ssd_state_walks, dim3(NH, B, 2),
      scan_smem_floats<kStates>() * sizeof(float), st, f(dt), f(a), f(x),
      f(b), f(h0), f(gy), f(c), f(gh), m(dh0), wk.states, wk.gstates, S, NH,
      HD, DS);
  if (err != cudaSuccess) return (int)err;
  err = launch_kernel(
      ssd_chunk_grads, dim3(ng, nc, B), grads_smem_bytes(), st, f(dt), f(a),
      f(x), f(b), f(c), f(gy), (const float*)wk.states,
      (const float*)wk.gstates, m(dx), m(ddt), wk.dbp, wk.dcp, wk.dap, S,
      NH, HD, DS);
  if (err != cudaSuccess) return (int)err;
  const size_t n = 2 * (size_t)B * S * DS + NH;
  return (int)launch_kernel(
      ssd_grads_reduce, dim3((unsigned)((n + kThreads - 1) / kThreads)), 0,
      st, (const float*)wk.dbp, (const float*)wk.dcp, (const float*)wk.dap,
      m(db), m(dc), m(da), B, S, DS, ng, nc, NH);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
