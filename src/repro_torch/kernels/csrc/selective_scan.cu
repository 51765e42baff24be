// Selective scan of the SSM blocks (Mamba-1 for falcon-mamba, Mamba-2 / SSD
// for zamba2).
//
// Replaces no Pallas kernel: it ports src/repro/models/ssm.py::selective_scan,
// which the reference computes outside Pallas as a chunked associative scan
// (its TPU form of the CUDA implementations' fused scan).  For each batch row
// b and channel d, from h_{-1} = h0[b, d, :]:
//
//   h_t[s] = exp(dt_t a[s]) h_{t-1}[s] + (dt_t x_t) B_t[s]
//   y_t    = sum_s h_t[s] C_t[s]             (s ascending)
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
// Bound: at zamba2's shapes, bytes (dt and x read once, y written once: the
// per-head exps are few); at falcon-mamba's, the B * S * DI * DS exps on the
// special-function units, near the bytes' time.  Nothing of size
// (S, DI, DS) is ever written.
//
// Design (simple first: no wgmma, TMA or parallel scan over time): one
// thread owns one (b, d) pair and keeps its DS state values in registers
// (with Mamba-1's DS decay rates), padded to a power of two kDS with zero
// rates, inputs and outputs, so the padded states stay 0 and add exact zeros
// to y.  A block is 128 consecutive channels of one batch row; it walks the
// sequence kTile steps at a time: the block stages the tile's B and C rows
// (shared by all its channels) and, for Mamba-2, the tile's per-head decays
// in shared memory, and each thread stages its own dt * x (and Mamba-1's dt)
// for the tile.  A tile's loads go to registers, all issued before any is
// used, so a tile waits for one memory latency, not one a step.  Then each
// thread steps through the tile in order, storing y_t as it goes.  On the
// H100 this runs at ~2.4x its bound at falcon-mamba's shapes (PERF.md):
// every warp reads each step's B and C from shared memory, 2 * DS values a
// step, which may be what holds it (not measured: no profiler counters on
// that machine).  Mamba-2's calls with head and state widths multiples of 8
// up to 64 and S > 1 (zamba2's prefill and training) run
// selective_scan_ssd.cu instead; this entry keeps its decode step and the
// other widths.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels a block
constexpr int kTile = 16;       // timesteps staged at a time

template <int kDS, bool kHeads>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ x,
                      const float* __restrict__ bg,
                      const float* __restrict__ cg,
                      const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_last,
                      int S, int DI, int DS, int NH, int HD) {
  // a thread's share of a tile's B (and C) values
  constexpr int kStage = (kTile * kDS + kThreads - 1) / kThreads;
  __shared__ float4 sb[kTile][kDS / 4];
  __shared__ float4 sc[kTile][kDS / 4];
  __shared__ float su[kTile][kThreads];                     // dt * x
  __shared__ float sd[kTile][kThreads];  // Mamba-1: dt; Mamba-2: decays

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + tid;
  const bool live = d < DI;
  // Mamba-2: the heads this block's channels span
  const int h_lo = kHeads ? d0 / HD : 0;
  const int n_heads = kHeads ? (min(d0 + kThreads, DI) - 1) / HD - h_lo + 1
                             : 0;

  float h[kDS];
  float rate[kHeads ? 1 : kDS];
#pragma unroll
  for (int s = 0; s < kDS; ++s) {
    h[s] = (live && s < DS) ? h0[((size_t)b * DI + d) * DS + s] : 0.f;
    if constexpr (!kHeads) {
      rate[s] = (live && s < DS) ? a[(size_t)d * DS + s] : 0.f;
    }
  }

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    const size_t row0 = (size_t)b * S + t0;   // (b, t0) in (B, S, .)
    // the tile's loads, all issued (unrolled, into registers) before any
    // is used
    float bl[kStage], cl[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = tid + j * kThreads;
      const int tt = i / kDS, s = i % kDS;
      const bool in = i < nt * kDS && s < DS;
      bl[j] = in ? bg[(row0 + tt) * DS + s] : 0.f;
      cl[j] = in ? cg[(row0 + tt) * DS + s] : 0.f;
    }
    float xl[kTile], dl[kTile];
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      const size_t r = (row0 + tt) * DI + d;
      const bool in = live && tt < nt;
      xl[tt] = in ? x[r] : 0.f;
      if constexpr (kHeads) {
        dl[tt] = in ? dt[(row0 + tt) * NH + d / HD] : 0.f;
      } else {
        dl[tt] = in ? dt[r] : 0.f;
      }
    }
    __syncthreads();                          // the last tile is consumed
    if constexpr (kHeads) {
      for (int i = tid; i < nt * n_heads; i += kThreads) {
        const int tt = i / n_heads, hh = h_lo + i % n_heads;
        sd[tt][i % n_heads] = expf(dt[(row0 + tt) * NH + hh] * a[hh]);
      }
    }
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
    for (int tt = 0; tt < kTile; ++tt) {      // rows past nt are not read
      su[tt][tid] = dl[tt] * xl[tt];
      if constexpr (!kHeads) sd[tt][tid] = dl[tt];
    }
    __syncthreads();
    if (!live) continue;
    const int head = kHeads ? d / HD - h_lo : 0;
    for (int tt = 0; tt < nt; ++tt) {
      const float u = su[tt][tid];
      const float dtv = sd[tt][kHeads ? head : tid];
      float acc = 0.f;
#pragma unroll
      for (int s4 = 0; s4 < kDS / 4; ++s4) {
        const float4 bv = sb[tt][s4];
        const float4 cv = sc[tt][s4];
        const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * s4 + j;
          float decay = dtv;                  // Mamba-2: the head's
          if constexpr (!kHeads) decay = expf(dtv * rate[s]);
          h[s] = fmaf(decay, h[s], u * bs[j]);
          acc = fmaf(h[s], cs[j], acc);
        }
      }
      y[(row0 + tt) * DI + d] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kDS; ++s) {
      if (s < DS) h_last[((size_t)b * DI + d) * DS + s] = h[s];
    }
  }
}

template <bool kHeads>
int launch(const float* dt, const float* a, const float* x, const float* bg,
           const float* cg, const float* h0, float* y, float* h_last, int B,
           int S, int DI, int DS, int NH, int HD, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || DI <= 0 || DS <= 0 || DS > 128
      || (kHeads && (NH <= 0 || HD <= 0 || NH * HD != DI))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((DI + kThreads - 1) / kThreads, B);
#define SCAN_RUN(KDS)                                                        \
  selective_scan_kernel<KDS, kHeads><<<grid, kThreads, 0, stream>>>(         \
      dt, a, x, bg, cg, h0, y, h_last, S, DI, DS, NH, HD)
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
