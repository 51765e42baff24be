// Selective scan of the SSM blocks (Mamba-1 for falcon-mamba, Mamba-2 / SSD
// for zamba2).
//
// Replaces no Pallas kernel: it ports src/repro/models/ssm.py::selective_scan,
// which the reference computes outside Pallas as a chunked associative scan
// (its TPU form of the CUDA implementations' fused scan).  For each batch row
// b and channel d, from h_{-1} = h0[b, d, :]:
//
//   h_t[s] = exp(dt_t a[s]) h_{t-1}[s] + (dt_t x_t) B_t[s]
//   y_t    = sum_s h_t[s] C_t[s]     (4 states a lane in order, then a tree
//                                     over the channel's lanes)
//
// and returns y (B, S, DI) and h_last = h_{S-1} (B, DI, DS), all float32.
// Two entries:
//   selective_scan_launch        Mamba-1: dt (B, S, DI), a (DI, DS);
//   selective_scan_heads_launch  Mamba-2: dt (B, S, NH), a (NH,), head width
//                                HD = DI / NH: channel d decays by
//                                exp(dt[b, t, d / HD] a[d / HD]) at every s,
//                                formed once per (b, t, head) in a block.
// x (B, S, DI), B and C (B, S, DS), h0 (B, DI, DS) for both.
//
// Bound: at zamba2's shapes, bytes (dt and x read once, y written once, the
// states once at decode: the per-head exps are few); at falcon-mamba's, the
// B * S * DI * DS exps on the special-function units (16 an SM a clock), near
// the bytes' time.  Nothing of size (S, DI, DS) is ever written.
//
// Design: a channel's DS states (padded to a power of two kDS >= 4 with zero
// rates, inputs and outputs, so the padded states stay 0 and add exact zeros
// to y) are split over a group of G = kDS / 4 neighbouring lanes, 4 states a
// lane in registers.  So h0 and h_last move as 16-byte accesses, neighbouring
// lanes on neighbouring addresses, each lane reads only its own float4 of B_t
// and C_t, and a block of 256 threads holds 256 / G channels: at
// falcon-mamba's DS = 16, 4x the warps of a thread a channel.  Mamba-1's decay
// is ex2.approx of dt * (a log2 e), the rates prescaled once: one multiply
// and one special-function op a state.  Each lane stores its share of y_t
// in shared memory; once a tile is stepped, each y_t is summed over its
// group by a halving tree (the sum xor shuffles would give) and the tile's y
// leaves as rows, so the steps spend no shuffle.  The block walks the
// sequence kTile steps at a time: it stages the tile's B and C rows (shared
// by its channels), dt x and dt for each channel and, for Mamba-2, the
// per-head decays in shared memory; the next tile's loads go to registers
// before the current tile is stepped, so they wait on no step, and each
// step's shared operands load while the step before it computes.  A decode
// step (S = 1) runs a kernel of its own that stages nothing and sums y_t by
// xor shuffles.  On the H100 this runs at ~2.2x its bound at falcon-mamba's
// shapes (PERF.md): the memory skeleton alone (loads, staging, barriers, y
// stores) takes ~0.57 of the time and the steps' arithmetic adds to it
// rather than hiding under it (scripts/scan_knockouts.py).  ex2.approx's
// error compounds along a carried state's decays: h_last comes within
// ~8e-6 of its largest magnitude of the plain version's (the bar: 1e-5).
// Mamba-2's calls with head and state widths multiples of 8 up to 64 and
// S > 1 (zamba2's prefill and training) run selective_scan_ssd.cu instead;
// this entry keeps its decode step and the other widths.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads a block, steps staged at a time (fewer where the block's static
// shared memory would pass 48 KB) and steps unrolled: compile-time settings,
// for scripts/kernel_variants.py
#ifndef SCAN_THREADS
#define SCAN_THREADS 256
#endif
#ifndef SCAN_TILE
#define SCAN_TILE 16
#endif
#ifndef SCAN_UNROLL
#define SCAN_UNROLL 16
#endif
constexpr int kThreads = SCAN_THREADS;
constexpr int kUnroll = SCAN_UNROLL;

// The staged tile's steps at state width kDS: SCAN_TILE, or fewer where a
// block's shared arrays (B and C rows, (dt x, dt) and the heads' decays a
// channel, the lanes' y shares) would pass 48 KB.
template <int kDS, bool kHeads>
__host__ __device__ constexpr int tile_steps() {
  constexpr int C = kThreads * 4 / kDS;
  constexpr int step_bytes = 2 * kDS * 4 + C * 8 + (kHeads ? C * 4 : 0)
                             + kThreads * 4;
  int t = SCAN_TILE;
  while (t > 1 && t * step_bytes > 48 * 1024) t /= 2;
  return t;
}
constexpr unsigned kAll = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// v[0..3] = p[s0 .. s0+3], zeros past DS or for a channel past DI; one
// 16-byte access where ``vec`` says p is aligned and DS a multiple of 4.
__device__ __forceinline__ void load4(float (&v)[4], const float* p, int s0,
                                      int DS, bool live, bool vec) {
  if (live && vec && s0 < DS) {
    const float4 q = *reinterpret_cast<const float4*>(p + s0);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = (live && s0 + j < DS) ? p[s0 + j] : 0.f;
}

__device__ __forceinline__ void store4(const float (&v)[4], float* p, int s0,
                                       int DS, bool live, bool vec) {
  if (!live || s0 >= DS) return;
  if (vec) {
    *reinterpret_cast<float4*>(p + s0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (s0 + j < DS) p[s0 + j] = v[j];
  }
}

// One step of a lane's 4 states: the decays (Mamba-2: the head's ``dec``;
// Mamba-1: 2^(dt rate')), the update, and the lane's share of y_t.
template <bool kHeads>
__device__ __forceinline__ float step(float (&h)[4], const float (&rate)[4],
                                      float u, float dtv, float dec,
                                      float4 bv, float4 cv) {
  const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
  const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
  float p = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float decay = kHeads ? dec : ex2(dtv * rate[j]);
    h[j] = fmaf(decay, h[j], u * bs[j]);
    p = j == 0 ? h[j] * cs[j] : fmaf(h[j], cs[j], p);
  }
  return p;
}

// The sum of a channel's G lane shares v[0 .. G), halved in place as the
// xor shuffles at offsets G/2, ..., 1 would sum them.
template <int G>
__device__ __forceinline__ float tree(float (&v)[G]) {
#pragma unroll
  for (int w = G / 2; w > 0; w >>= 1) {
#pragma unroll
    for (int k = 0; k < w; ++k) v[k] += v[k + w];
  }
  return v[0];
}

template <int kDS, bool kHeads>
__global__ void __launch_bounds__(kThreads)
scan_lanes_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                  const float* __restrict__ x, const float* __restrict__ bg,
                  const float* __restrict__ cg, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ h_last, int S,
                  int DI, int DS, int NH, int HD, bool vec) {
  constexpr int G = kDS / 4;              // lanes a channel
  constexpr int C = kThreads / G;         // channels a block
  constexpr int kTile = tile_steps<kDS, kHeads>();
  constexpr int kStage = (kTile * kDS + kThreads - 1) / kThreads;  // B, C
  // a thread's (dt, x) pairs and heads' decays (a tile has kTile C)
  constexpr int kUStage = (kTile * C + kThreads - 1) / kThreads;
  __shared__ float4 sb[kTile][G];
  __shared__ float4 sc[kTile][G];
  __shared__ float2 sud[kTile][C];      // (dt x, Mamba-1's dt)
  __shared__ float sdec[kHeads ? kTile : 1][C];   // Mamba-2: heads' decays
  __shared__ __align__(16) float sp[kTile][kThreads];   // lanes' y shares

  const int tid = threadIdx.x, g = tid % G, c = tid / G;
  const int b = blockIdx.y, d0 = blockIdx.x * C, d = d0 + c;
  const bool live = d < DI;
  // Mamba-2: the heads this block's channels span
  const int h_lo = kHeads ? d0 / HD : 0;
  const int n_heads = kHeads ? (min(d0 + C, DI) - 1) / HD - h_lo + 1 : 1;
  const int head = kHeads ? d / HD - h_lo : 0;

  float h[4], rate[4];
  load4(h, h0 + ((size_t)b * DI + d) * DS, 4 * g, DS, live, vec);
  if constexpr (!kHeads) {
    load4(rate, a + (size_t)d * DS, 4 * g, DS, live, vec);
#pragma unroll
    for (int j = 0; j < 4; ++j) rate[j] *= kLog2e;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) rate[j] = 0.f;
  }

  // the next tile's loads, in registers
  float bl[kStage], cl[kStage], xl[kUStage], dl[kUStage], hl[kUStage];
  auto fetch = [&](int t0) {
    const int nt = min(kTile, S - t0);
    const size_t row0 = (size_t)b * S + t0;
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = tid + j * kThreads;
      const int tt = i / kDS, s = i % kDS;
      const bool in = tt < nt && s < DS;
      bl[j] = in ? bg[(row0 + tt) * DS + s] : 0.f;
      cl[j] = in ? cg[(row0 + tt) * DS + s] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kUStage; ++j) {
      const int i = tid + j * kThreads;
      const int tt = i / C, dd = d0 + i % C;
      const bool in = tt < nt && dd < DI;
      xl[j] = in ? x[(row0 + tt) * DI + dd] : 0.f;
      if constexpr (kHeads) {
        dl[j] = in ? dt[(row0 + tt) * NH + dd / HD] : 0.f;
        const int th = i / n_heads, hh = h_lo + i % n_heads;
        hl[j] = th < nt ? dt[(row0 + th) * NH + hh] * a[hh] : 0.f;
      } else {
        dl[j] = in ? dt[(row0 + tt) * DI + dd] : 0.f;
      }
    }
  };
  // a finished tile's y, each summed over its channel's lanes, as rows
  auto flush = [&](int t0, int nt) {
    const size_t row0 = (size_t)b * S + t0;
#pragma unroll
    for (int j = 0; j < kUStage; ++j) {
      const int i = tid + j * kThreads;
      const int tt = i / C, cc = i % C;
      if (tt >= nt) continue;
      float v[G];
      if constexpr (G % 4 == 0) {
#pragma unroll
        for (int k = 0; k < G; k += 4) {
          const float4 q =
              *reinterpret_cast<const float4*>(&sp[tt][cc * G + k]);
          v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < G; ++k) v[k] = sp[tt][cc * G + k];
      }
      if (d0 + cc < DI) y[(row0 + tt) * DI + d0 + cc] = tree<G>(v);
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    __syncthreads();                  // the last tile is stepped
    if (t0 > 0) flush(t0 - kTile, kTile);
    float* sbf = &sb[0][0].x;
    float* scf = &sc[0][0].x;
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = tid + j * kThreads;
      if (i < kTile * kDS) {
        sbf[i] = bl[j];
        scf[i] = cl[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kUStage; ++j) {   // rows past nt are not read
      const int i = tid + j * kThreads;
      if (i >= kTile * C) continue;
      (&sud[0][0])[i] = make_float2(dl[j] * xl[j], dl[j]);
      if constexpr (kHeads) {
        if (i < kTile * n_heads) sdec[i / n_heads][i % n_heads] = expf(hl[j]);
      }
    }
    __syncthreads();
    if (t0 + kTile < S) fetch(t0 + kTile);
    // a step's operands from shared memory: (dt x, dt), the head's decay,
    // the lane's B_t and C_t
    struct Ops {
      float2 ud;
      float dec;
      float4 bv, cv;
    };
    auto operands = [&](int tt) {
      Ops o{sud[tt][c], 0.f, sb[tt][g], sc[tt][g]};
      if constexpr (kHeads) o.dec = sdec[tt][head];
      return o;
    };
    // step tt with the next step's operands already loading, so no step
    // waits on shared memory behind the last one's store
    Ops cur = operands(0);
    auto one = [&](int tt) {
      const Ops next = tt + 1 < nt ? operands(tt + 1) : cur;
      sp[tt][tid] = step<kHeads>(h, rate, cur.ud.x, cur.ud.y, cur.dec,
                                 cur.bv, cur.cv);
      cur = next;
    };
    if (nt == kTile) {
#pragma unroll kUnroll
      for (int tt = 0; tt < kTile; ++tt) one(tt);
    } else {
      for (int tt = 0; tt < nt; ++tt) one(tt);
    }
  }
  __syncthreads();
  flush(((S - 1) / kTile) * kTile, S - ((S - 1) / kTile) * kTile);
  store4(h, h_last + ((size_t)b * DI + d) * DS, 4 * g, DS, live, vec);
}

// S = 1: one step from the loaded state, nothing staged.
template <int kDS, bool kHeads>
__global__ void __launch_bounds__(kThreads)
scan_lanes_decode_kernel(const float* __restrict__ dt,
                         const float* __restrict__ a,
                         const float* __restrict__ x,
                         const float* __restrict__ bg,
                         const float* __restrict__ cg,
                         const float* __restrict__ h0,
                         float* __restrict__ y, float* __restrict__ h_last,
                         int DI, int DS, int NH, int HD, bool vec) {
  constexpr int G = kDS / 4, C = kThreads / G;
  const int tid = threadIdx.x, g = tid % G;
  const int b = blockIdx.y, d = blockIdx.x * C + tid / G;
  const bool live = d < DI;
  const size_t hrow = ((size_t)b * DI + d) * DS;
  float h[4], rate[4], bs[4], cs[4];
  load4(h, h0 + hrow, 4 * g, DS, live, vec);
  load4(bs, bg + (size_t)b * DS, 4 * g, DS, true, vec);
  load4(cs, cg + (size_t)b * DS, 4 * g, DS, true, vec);
  float dtv = 0.f, xv = 0.f, dec = 0.f;
  if (live) {
    xv = x[(size_t)b * DI + d];
    if constexpr (kHeads) {
      const int hh = d / HD;
      dtv = dt[(size_t)b * NH + hh];
      dec = expf(dtv * a[hh]);
    } else {
      dtv = dt[(size_t)b * DI + d];
    }
  }
  if constexpr (!kHeads) {
    load4(rate, a + (size_t)d * DS, 4 * g, DS, live, vec);
#pragma unroll
    for (int j = 0; j < 4; ++j) rate[j] *= kLog2e;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) rate[j] = 0.f;
  }
  float p = step<kHeads>(
      h, rate, dtv * xv, dtv, dec, make_float4(bs[0], bs[1], bs[2], bs[3]),
      make_float4(cs[0], cs[1], cs[2], cs[3]));
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) p += __shfl_xor_sync(kAll, p, off);
  if (live && g == 0) y[(size_t)b * DI + d] = p;
  store4(h, h_last + hrow, 4 * g, DS, live, vec);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kHeads>
int launch(const float* dt, const float* a, const float* x, const float* bg,
           const float* cg, const float* h0, float* y, float* h_last, int B,
           int S, int DI, int DS, int NH, int HD, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || DI <= 0 || DS <= 0 || DS > 128
      || (kHeads && (NH <= 0 || HD <= 0 || NH * HD != DI))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte state, rate, B and C accesses where every row starts aligned
  const bool vec = DS % 4 == 0 && aligned16(h0) && aligned16(h_last)
                   && aligned16(bg) && aligned16(cg)
                   && (kHeads || aligned16(a));
#define SCAN_RUN(KDS)                                                        \
  do {                                                                       \
    const dim3 grid((DI + kThreads * 4 / (KDS) - 1) / (kThreads * 4 / (KDS)), \
                    B);                                                      \
    if (S == 1) {                                                            \
      scan_lanes_decode_kernel<KDS, kHeads><<<grid, kThreads, 0, stream>>>(  \
          dt, a, x, bg, cg, h0, y, h_last, DI, DS, NH, HD, vec);             \
    } else {                                                                 \
      scan_lanes_kernel<KDS, kHeads><<<grid, kThreads, 0, stream>>>(         \
          dt, a, x, bg, cg, h0, y, h_last, S, DI, DS, NH, HD, vec);          \
    }                                                                        \
  } while (0)
  if (DS <= 4) {
    SCAN_RUN(4);
  } else if (DS <= 8) {
    SCAN_RUN(8);
  } else if (DS <= 16) {
    SCAN_RUN(16);
  } else if (DS <= 32) {
    SCAN_RUN(32);
  } else if (DS <= 64) {
    SCAN_RUN(64);
  } else {
    SCAN_RUN(128);
  }
#undef SCAN_RUN
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int selective_scan_launch(const void* dt, const void* a,
                                     const void* x, const void* b,
                                     const void* c, const void* h0, void* y,
                                     void* h_last, int B, int S, int DI,
                                     int DS, void* stream) {
  return launch<false>(
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(x), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), B, S, DI, DS, 0,
      0, static_cast<cudaStream_t>(stream));
}

extern "C" int selective_scan_heads_launch(const void* dt, const void* a,
                                           const void* x, const void* b,
                                           const void* c, const void* h0,
                                           void* y, void* h_last, int B,
                                           int S, int NH, int HD, int DS,
                                           void* stream) {
  return launch<true>(
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(x), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), B, S, NH * HD, DS,
      NH, HD, static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
