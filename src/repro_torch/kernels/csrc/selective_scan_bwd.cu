// Backward of the selective scan of the SSM blocks (Mamba-1 for
// falcon-mamba, Mamba-2 / SSD for zamba2).
//
// Replaces no Pallas kernel: it ports the JAX gradient of
// src/repro/models/ssm.py::selective_scan (the reference differentiates its
// chunked associative scan).  The forward (selective_scan.cu), for each batch
// row b and channel d, from h_{-1} = h0[b, d, :]:
//
//   h_t[s] = A_t[s] h_{t-1}[s] + u_t B_t[s],  A_t[s] = exp(dt_t a[s]),
//   u_t = dt_t x_t,  y_t = sum_s h_t[s] C_t[s].
//
// Given gy (B, S, DI), the cotangent of y, and gh (B, DI, DS), that of
// h_last, the gradient g_t = dL/dh_t runs in reverse:
//
//   g_t[s] = gy_t C_t[s] + A_{t+1}[s] g_{t+1}[s]     (g_{S-1} adds gh)
//
// and, with gA_t[s] = g_t[s] h_{t-1}[s] A_t[s] and du_t = sum_s g_t[s] B_t[s]:
//
//   dx_t   = du_t dt_t
//   ddt_t  = du_t x_t + sum_s a[s] gA_t[s]     (Mamba-2: summed over the
//                                               head's channels)
//   da[s]  = sum_{b, t} dt_t gA_t[s]           (Mamba-2: and over the head's
//                                               channels and the states)
//   dB_t[s] = sum_d g_t[d, s] u_t[d],   dC_t[s] = sum_d gy_t[d] h_t[d, s]
//   dh0[s] = A_0[s] g_0[s]
//
// all float32.  Two entries, as the forward's: selective_scan_bwd_launch
// with heads = 0 (Mamba-1: dt (B, S, DI), a (DI, DS)) or 1 (Mamba-2: dt
// (B, S, NH), a (NH,), head width HD = DI / NH).  Mamba-2's calls that the
// SSD kernels take (selective_scan_ssd.cu: widths multiples of 8 up to 64,
// S >= 20, where they overtake this kernel) run there instead.
//
// Bound: the bytes (dt, x, gy read once, dx and ddt written once, the rest
// small) at zamba2's shapes; at falcon-mamba's the B * S * DI * DS exps.
//
// Rules of both designs below.  h_{t-1} is never recovered by dividing by
// A_t, which underflows; it is recomputed forward from stored states, and
// nothing of size (S, DI, DS) is ever in memory.  Sums over channels (dB,
// dC) are taken in a fixed order into per-block partials (B, nblk, S, DS);
// da's per (b, d, s) partials (Mamba-2: per (b, d)), Mamba-2's per-channel
// ddt and the partials are summed by a second kernel in a fixed order.  No
// float atomics: two runs give the same bits.  The stored states and
// partials live in one workspace that the caller allocates
// (selective_scan_bwd_workspace gives its float count).
//
// Mamba-1: scan_bwd_tiles_kernel, designed for Hopper.  What held the first
// design (below) back was latency, not work: each 4-step tile waited for
// its own loads, paid five barriers and summed dB and dC over 64 channels
// serially on a quarter of the threads (scripts/scan_knockouts.py --mode
// bwd; PERF.md).  Here:
//  * a channel's DS states are split 4 a lane over kG = kDS / 4 lanes, so a
//    block of 256 threads holds kCPB = 1024 / kDS channels of a batch row;
//  * time is walked in chunks of kC steps (32 from kDS = 16 on), staged in
//    shared memory by cp.async one chunk ahead of use: each thread waits
//    for its copies, one barrier hands the chunk over, and the next chunk's
//    copies are issued before the current one is computed.  The chunks are
//    walked forward (pass 1: the state at each chunk's start, stored), then
//    in reverse, where a chunk's dt, x, gy, B and C rows serve both:
//    pass 2 reruns the chunk from its stored state and keeps the state at
//    the start of each kR-step register tile in shared memory, and pass 3
//    walks the tiles in reverse: it reruns a tile into registers, keeping
//    each step's state and decays, and steps back through it carrying g.
//    So each A_t is formed at most three times, not four;
//  * dB's and dC's terms are summed over a warp's channels by xor shuffles
//    that halve the values a lane holds at each stage (a fixed butterfly),
//    then over the block's warps in warp order through shared memory: one
//    barrier a register tile (double-buffered rows);
//  * a decay is 0.5 * 2^(dt a log2 e + 1) by ex2.approx (``decay``): three
//    instructions, not expf's eight, and no more biased than expf, where
//    the forward kernel's 2^(dt a log2 e) would drift along a carried
//    state's long chains past the 1e-5 bar.
//
// Mamba-2 (selective_scan_bwd_kernel, the first design): channels
// split over lanes as above, kNS of 4, 8 or 16 states a lane; pass 1 stores
// the state every kChunk = 128 steps, pass 2 reruns a chunk storing the
// state at each kT = 4-step tile, pass 3 reruns each tile into registers
// and steps back through it; a head's decay is one exp a channel and step.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SCAN_BWD_TILE
#define SCAN_BWD_TILE 8
#endif
#ifndef SCAN_BWD_CHUNK
#define SCAN_BWD_CHUNK 32
#endif

namespace {

constexpr int kThreads = 256;   // a block
constexpr int kWarps = kThreads / 32;
constexpr int kT = 4;           // steps a register tile (Mamba-2)
constexpr int kChunk = 128;     // steps between the states pass 1 stores
constexpr int kTiles = kChunk / kT;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kR = SCAN_BWD_TILE;   // steps a register tile (Mamba-1)

// Mamba-1's staged chunk at padded state width kds: SCAN_BWD_CHUNK steps,
// fewer where a block's channels are many (1024 / kds), so a chunk's
// per-channel rows stay at 6,144 floats; a multiple of kR
__host__ __device__ constexpr int tile_chunk(int kds) {
  const int c = SCAN_BWD_CHUNK < 2 * kds ? SCAN_BWD_CHUNK : 2 * kds;
  return c / kR * kR > kR ? c / kR * kR : kR;
}

__host__ __device__ constexpr int states_a_lane(int kds) {
  return kds <= 16 ? 4 : (kds <= 64 ? 8 : 16);
}

int padded_state(int ds) {
  int k = 4;
  while (k < ds) k *= 2;
  return k;
}

int channels_a_block(int ds) {
  const int kds = padded_state(ds);
  return kThreads / (kds / states_a_lane(kds));
}

struct Work {            // the workspace, carved (floats)
  float *ckpt, *tiles, *pdb, *pdc, *pda, *pddt;
};

// blocks a batch row: Mamba-1's tiled kernel holds 1024 / kds channels,
// Mamba-2's 256 / (kds / kNS)
int blocks_a_row(int DI, int DS, bool heads) {
  const int cpb = heads ? channels_a_block(DS) : 1024 / padded_state(DS);
  return (DI + cpb - 1) / cpb;
}

// the workspace's parts, in floats: the chunk starts, (Mamba-2) the tile
// starts (each a state of every block's lanes), the dB and dC partials,
// da's and (Mamba-2) ddt's per-channel terms
void parts(size_t (&n)[6], int B, int S, int DI, int DS, bool heads) {
  const int kds = padded_state(DS);
  const size_t steps = heads ? kChunk : tile_chunk(kds);
  const size_t nc = (S + steps - 1) / steps;
  const size_t nblk = blocks_a_row(DI, DS, heads);
  const size_t state = (size_t)DI * DS;
  const size_t lanes = nblk * kThreads
      * (heads ? states_a_lane(kds) : 4);       // a padded state
  n[0] = B * nc * lanes;
  n[1] = heads ? B * kTiles * lanes : 0;
  n[2] = B * nblk * S * DS;
  n[3] = n[2];
  n[4] = B * state;
  n[5] = heads ? (size_t)B * S * DI : 0;
}

Work carve(float* ws, int B, int S, int DI, int DS, bool heads) {
  size_t n[6];
  parts(n, B, S, DI, DS, heads);
  float* p[6];
  for (int k = 0; k < 6; ++k) {
    p[k] = ws;
    ws += n[k];
  }
  return Work{p[0], p[1], p[2], p[3], p[4], p[5]};
}

size_t workspace_floats(int B, int S, int DI, int DS, bool heads) {
  size_t n[6];
  parts(n, B, S, DI, DS, heads);
  return n[0] + n[1] + n[2] + n[3] + n[4] + n[5];
}

// one forward step of a lane's kNS states under the head's decay rate
template <int kNS>
__device__ __forceinline__ void step(float (&out)[kNS], const float (&in)[kNS],
                                     const float* sb, float dtv, float u,
                                     float rate) {
  const float decay = expf(dtv * rate);
#pragma unroll
  for (int j = 0; j < kNS; ++j) out[j] = fmaf(decay, in[j], u * sb[j]);
}

template <int kNS>
__device__ __forceinline__ void load_state(float (&h)[kNS], const float* src,
                                           bool live, int s0, int DS) {
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    h[j] = (live && s0 + j < DS) ? src[s0 + j] : 0.f;
  }
}

template <int kNS>
__device__ __forceinline__ void store_state(float* dst, const float (&h)[kNS],
                                            bool live, int s0, int DS) {
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    if (live && s0 + j < DS) dst[s0 + j] = h[j];
  }
}

template <int kDS>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const float* __restrict__ x,
                          const float* __restrict__ bg,
                          const float* __restrict__ cg,
                          const float* __restrict__ h0,
                          const float* __restrict__ gy,
                          const float* __restrict__ gh,
                          float* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ dh0, Work w, int S, int DI,
                          int DS, int NH, int HD) {
  constexpr int kNS = states_a_lane(kDS);
  constexpr int kG = kDS / kNS;            // lanes a channel
  constexpr int kCPB = kThreads / kG;      // channels a block
  constexpr int kRed = kNS + 1;            // padded: no bank conflicts
  extern __shared__ float4 smem4[];
  float* sb = reinterpret_cast<float*>(smem4);   // [kT][kDS]
  float* sc = sb + kT * kDS;                     // [kT][kDS]
  float* red = sc + kT * kDS;                    // [kT][kThreads][kRed]

  const int tid = threadIdx.x;
  const int lane = tid % kG;
  const int b = blockIdx.y;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int d = blk * kCPB + tid / kG;
  const bool live = d < DI;
  const int s0 = lane * kNS;
  const int head = live ? d / HD : 0;
  const int nc = (S + kChunk - 1) / kChunk;
  const size_t row = (size_t)b * DI + d;   // (b, d) in (B, DI, .)
  // a stored state: k-th of batch row b, this thread's kNS values apart by
  // every block's lanes
  const size_t lanes = (size_t)nblk * kThreads;
  auto stored = [&](float* base, int k) {
    return base + (size_t)k * kNS * lanes + (size_t)blk * kThreads + tid;
  };
  auto put = [&](float* p, const float (&h)[kNS]) {
#pragma unroll
    for (int j = 0; j < kNS; ++j) p[j * lanes] = h[j];
  };
  auto get = [&](float (&h)[kNS], const float* p) {
#pragma unroll
    for (int j = 0; j < kNS; ++j) h[j] = p[j * lanes];
  };

  const float rate = live ? a[head] : 0.f;

  // a tile's per-channel inputs, into registers; its B (and C) rows into
  // shared memory
  float dl[kT], xl[kT], gl[kT];
  auto load_tile = [&](int t0, int nt, bool grad) {
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      const bool in = live && tt < nt;
      const size_t r = ((size_t)b * S + t0 + tt) * DI + d;
      dl[tt] = in ? dt[((size_t)b * S + t0 + tt) * NH + head] : 0.f;
      xl[tt] = in ? x[r] : 0.f;
      gl[tt] = (in && grad) ? gy[r] : 0.f;
    }
    __syncthreads();                       // the last tile is consumed
    for (int i = tid; i < kT * kDS; i += kThreads) {
      const int tt = i / kDS, s = i % kDS;
      const bool in = tt < nt && s < DS;
      const size_t r = ((size_t)b * S + t0 + tt) * DS + s;
      sb[i] = in ? bg[r] : 0.f;
      if (grad) sc[i] = in ? cg[r] : 0.f;
    }
    __syncthreads();
  };
  // the block's sums over its channels of red's rows, in channel order,
  // into its partial rows of out (B, nblk, S, DS)
  auto reduce = [&](float* out, int t0, int nt) {
    __syncthreads();
    for (int i = tid; i < kT * kDS; i += kThreads) {
      const int tt = i / kDS, s = i % kDS;
      if (tt < nt && s < DS) {
        const int ln = s / kNS, j = s % kNS;
        const float* src = red + ((size_t)tt * kThreads + ln) * kRed + j;
        float acc = 0.f;
        for (int ch = 0; ch < kCPB; ++ch) acc += src[ch * kG * kRed];
        out[(((size_t)b * nblk + blk) * S + t0 + tt) * DS + s] = acc;
      }
    }
  };
  float* myred = red + (size_t)tid * kRed;

  // pass 1: the state at the start of every chunk
  float h[kNS];
  load_state<kNS>(h, h0 + row * DS, live, s0, DS);
  for (int c = 0; c < nc; ++c) {
    put(stored(w.ckpt, b * nc + c), h);
    if (c == nc - 1) break;
    for (int t0 = c * kChunk; t0 < (c + 1) * kChunk; t0 += kT) {
      load_tile(t0, kT, false);
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) {
        step<kNS>(h, h, sb + tt * kDS + s0, dl[tt], dl[tt] * xl[tt], rate);
      }
    }
  }

  // the reverse walk
  float g[kNS];
  load_state<kNS>(g, gh + row * DS, live, s0, DS);
  float dacc = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * kChunk, c1 = min(S, c0 + kChunk);
    // pass 2: the state at the start of each of the chunk's tiles
    get(h, stored(w.ckpt, b * nc + c));
    for (int t0 = c0; t0 < c1; t0 += kT) {
      put(stored(w.tiles, b * kTiles + (t0 - c0) / kT), h);
      if (t0 + kT >= c1) break;
      load_tile(t0, kT, false);
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) {
        step<kNS>(h, h, sb + tt * kDS + s0, dl[tt], dl[tt] * xl[tt], rate);
      }
    }
    // pass 3: the chunk's tiles in reverse
    for (int t0 = c0 + (c1 - c0 - 1) / kT * kT; t0 >= c0; t0 -= kT) {
      const int nt = min(kT, c1 - t0);
      float hs[kT + 1][kNS];               // hs[tt + 1] = h_{t0 + tt}
      get(hs[0], stored(w.tiles, b * kTiles + (t0 - c0) / kT));
      load_tile(t0, nt, true);
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) {
        if (tt < nt) {
          step<kNS>(hs[tt + 1], hs[tt], sb + tt * kDS + s0, dl[tt],
                    dl[tt] * xl[tt], rate);
        }
      }
      // dC's terms: gy_t h_t
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) {
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          myred[tt * kThreads * kRed + j] = tt < nt ? gl[tt] * hs[tt + 1][j]
                                                    : 0.f;
        }
      }
      reduce(w.pdc, t0, nt);
      __syncthreads();                     // red is read
#pragma unroll
      for (int tt = kT - 1; tt >= 0; --tt) {
        if (tt < nt) {
          const float* bt = sb + tt * kDS + s0;
          const float* ct = sc + tt * kDS + s0;
          const float u = dl[tt] * xl[tt];
          const float decay = expf(dl[tt] * rate);
          float du = 0.f, gdec = 0.f;
#pragma unroll
          for (int j = 0; j < kNS; ++j) {
            const float gt = fmaf(gl[tt], ct[j], g[j]);
            du = fmaf(gt, bt[j], du);
            gdec += gt * hs[tt][j] * decay;
            myred[tt * kThreads * kRed + j] = gt * u;     // dB's term
            g[j] = decay * gt;
          }
          dacc = fmaf(dl[tt], gdec, dacc);
          gdec *= rate;
#pragma unroll
          for (int off = kG / 2; off > 0; off /= 2) {
            du += __shfl_xor_sync(kFull, du, off);
            gdec += __shfl_xor_sync(kFull, gdec, off);
          }
          if (live && lane == 0) {
            const size_t r = ((size_t)b * S + t0 + tt) * DI + d;
            dx[r] = du * dl[tt];
            ddt[r] = fmaf(du, xl[tt], gdec);
          }
        } else {
#pragma unroll
          for (int j = 0; j < kNS; ++j) myred[tt * kThreads * kRed + j] = 0.f;
        }
      }
      reduce(w.pdb, t0, nt);
    }
  }
  store_state<kNS>(dh0 + row * DS, g, live, s0, DS);
  // the channel's share of da: its lanes' summed, at (b, d)
#pragma unroll
  for (int off = kG / 2; off > 0; off /= 2) {
    dacc += __shfl_xor_sync(kFull, dacc, off);
  }
  if (live && lane == 0) w.pda[row] = dacc;
}

// ---- Mamba-1: the tiled kernel (the header) ---------------------------------

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// A_t = exp(dt a) from a log2 e (``r2``) as 0.5 ex2.approx(dt r2 + 1).  A
// decay's error compounds along a state's chain of decays, so its bias
// counts: ex2.approx of the negative dt r2 itself runs ~-2e-8 low on
// average (it drifts da / dh0 past the 1e-5 bar with a carried state), of
// the argument moved up by one no more than expf's ~5e-9 for dt a in
// [-1, 0), where chains are long, at three instructions instead of eight
// (scripts/exp_bias.py; both forms are variants in
// scripts/kernel_variants.py)
__device__ __forceinline__ float decay(float dtv, float r2) {
  return 0.5f * ex2(fmaf(dtv, r2, 1.f));
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
  }
}

// v[0..4), a lane's terms of its 4 states, summed over the warp's channels
// (the lanes whose bits kG and up differ) by xor shuffles from bit 16 down:
// while a lane holds more than one value, each stage halves them (the lane
// keeps the half its bit names and adds the partner's share of it), then
// whole values are summed.  The sums land in the lane's first values
// (``SumSlot`` says how many, and of which states).
template <int kG, int kM = 16, int kCnt = 4>
__device__ __forceinline__ void channel_sum(float (&v)[4], int lane) {
  if constexpr (kM >= kG && kM > 0) {
    const bool hi = (lane & kM) != 0;
    if constexpr (kCnt > 1) {
      constexpr int kH = kCnt / 2;
#pragma unroll
      for (int i = 0; i < kH; ++i) {
        const float send = hi ? v[i] : v[i + kH];
        const float keep = hi ? v[i + kH] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, kM);
      }
      channel_sum<kG, kM / 2, kH>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], kM);
      channel_sum<kG, kM / 2, 1>(v, lane);
    }
  }
}

// after channel_sum: the values a lane holds, the state of its first, and
// whether it writes them (of the lanes holding the same sums, the one whose
// whole-value stage bits are 0)
template <int kG>
struct SumSlot {
  static constexpr int kOut = kG >= 32 ? 4 : (kG >= 16 ? 2 : 1);
  int state;
  bool writer;
  __device__ explicit SumSlot(int lane) {
    int off = 0;
    if (kG <= 16 && (lane & 16)) off += 2;
    if (kG <= 8 && (lane & 8)) off += 1;
    state = 4 * (lane % kG) + off;
    writer = (lane & (7 & ~(kG - 1))) == 0;
  }
};

template <int kDS>
struct Tiles {
  static constexpr int kG = kDS / 4;              // lanes a channel
  static constexpr int kCPB = kThreads / kG;      // channels a block
  static constexpr int kC = tile_chunk(kDS);      // steps a chunk
  static constexpr int kSub = kC / kR;            // register tiles a chunk
  static constexpr int kBuf = kC * (3 * kCPB + 2 * kDS);  // a staged chunk
  static constexpr int kPart = kWarps * kR * kDS;         // a tile's rows
  // floats: two staged chunks, the tile starts, 2 x (dB, dC) warp rows
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kBuf + kSub * 4 * kThreads + 4 * kPart);
};

template <int kDS>
__global__ void __launch_bounds__(kThreads, 2)   // two blocks an SM
scan_bwd_tiles_kernel(const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ x,
                      const float* __restrict__ bg,
                      const float* __restrict__ cg,
                      const float* __restrict__ h0,
                      const float* __restrict__ gy,
                      const float* __restrict__ gh,
                      float* __restrict__ dx, float* __restrict__ ddt,
                      float* __restrict__ dh0, Work w, int S, int DI, int DS,
                      bool vec) {
  using T = Tiles<kDS>;
  constexpr int kG = T::kG, kCPB = T::kCPB, kC = T::kC, kSub = T::kSub;
  extern __shared__ float4 smem4[];
  float* const buf0 = reinterpret_cast<float*>(smem4);
  float* const hst = buf0 + 2 * T::kBuf;          // [kSub][4][kThreads]
  float* const part = hst + kSub * 4 * kThreads;  // [2][2][kWarps][kR][kDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = tid / kG;                  // the thread's channel
  const int s0 = (tid % kG) * 4;            // its first state
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * kCPB, d = d0 + ch;
  const bool live = d < DI;
  const size_t row = (size_t)b * DI + d;
  const int nc = (S + kC - 1) / kC;
  const SumSlot<kG> slot(lane);

  // a chunk's staged rows: dt, x, gy [kC][kCPB]; B, C [kC][kDS]
  struct Chunk {
    float *dt, *x, *gy, *b, *c;
  };
  auto chunk_at = [&](int k) {
    float* p = buf0 + (k & 1) * T::kBuf;
    return Chunk{p, p + kC * kCPB, p + 2 * kC * kCPB, p + 3 * kC * kCPB,
                 p + 3 * kC * kCPB + kC * kDS};
  };
  // stage chunk c (steps c kC ..) into buffer k; gy and C for the reverse
  auto fill = [&](int k, int c, bool grad) {
    const Chunk sm = chunk_at(k);
    const int t0 = c * kC;
    const int v = vec ? 4 : 1;
    for (int i = tid; i < kC * kCPB / v; i += kThreads) {
      const int tt = i / (kCPB / v), cc = (i % (kCPB / v)) * v;
      const bool ok = t0 + tt < S && d0 + cc < DI;
      const size_t r = ok ? ((size_t)b * S + t0 + tt) * DI + d0 + cc : 0;
      cp_async(sm.dt + tt * kCPB + cc, dt + r, vec, ok);
      cp_async(sm.x + tt * kCPB + cc, x + r, vec, ok);
      if (grad) cp_async(sm.gy + tt * kCPB + cc, gy + r, vec, ok);
    }
    for (int i = tid; i < kC * kDS / v; i += kThreads) {
      const int tt = i / (kDS / v), ss = (i % (kDS / v)) * v;
      const bool ok = t0 + tt < S && ss < DS;
      const size_t r = ok ? ((size_t)b * S + t0 + tt) * DS + ss : 0;
      cp_async(sm.b + tt * kDS + ss, bg + r, vec, ok);
      if (grad) cp_async(sm.c + tt * kDS + ss, cg + r, vec, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto ld4 = [](float (&v)[4], const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  };
  // the stored state at chunk c's start: a thread's 4 values side by side
  auto ckpt = [&](int c) {
    return reinterpret_cast<float4*>(w.ckpt) +
           (((size_t)b * nc + c) * nblk + blk) * kThreads + tid;
  };

  float rate[4], rate2[4];                  // a, a log2 e
  load_state<4>(rate, a + (size_t)d * DS, live, s0, DS);
#pragma unroll
  for (int j = 0; j < 4; ++j) rate2[j] = rate[j] * kLog2e;
  float h[4], g[4], dacc[4] = {0.f, 0.f, 0.f, 0.f};
  load_state<4>(h, h0 + row * DS, live, s0, DS);
  load_state<4>(g, gh + row * DS, live, s0, DS);
  // one forward step of the thread's states from chunk sm's step tt
  auto step = [&](float (&hv)[4], const Chunk& sm, int tt) {
    const float dtv = sm.dt[tt * kCPB + ch];
    const float u = dtv * sm.x[tt * kCPB + ch];
    float bv[4];
    ld4(bv, sm.b + tt * kDS + s0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hv[j] = fmaf(decay(dtv, rate2[j]), hv[j], u * bv[j]);
    }
  };

  // the fills: chunks 0 .. nc - 2 forward (pass 1), then nc - 1 .. 0
  const int nfill = 2 * nc - 1;
  auto chunk_of = [&](int i) { return i < nc - 1 ? i : 2 * nc - 2 - i; };
  fill(0, 0, nc == 1);
  float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
  int par = 0;                              // the warp rows' buffer
  for (int i = 0; i < nfill; ++i) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();                        // chunk i staged, i - 1 consumed
    if (i + 1 < nfill) fill(i + 1, chunk_of(i + 1), i + 1 >= nc - 1);
    const Chunk sm = chunk_at(i);
    const int c = chunk_of(i), t0 = c * kC;
    if (i < nc - 1) {                       // pass 1
      *ckpt(c) = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll 4
      for (int tt = 0; tt < kC; ++tt) step(h, sm, tt);
      continue;
    }
    if (c < nc - 1) {
      h[0] = next.x; h[1] = next.y; h[2] = next.z; h[3] = next.w;
    }
    if (c > 0) next = *ckpt(c - 1);         // ahead of its use
    // pass 2: the state at each register tile's start
    for (int sub = 0; sub < kSub; ++sub) {
#pragma unroll
      for (int j = 0; j < 4; ++j) hst[(sub * 4 + j) * kThreads + tid] = h[j];
      if (sub + 1 == kSub) break;
#pragma unroll
      for (int tt = 0; tt < kR; ++tt) step(h, sm, sub * kR + tt);
    }
    // pass 3: the register tiles in reverse
    for (int sub = kSub - 1; sub >= 0; --sub) {
      float* const rows = part + par * 2 * T::kPart;   // [dB, dC][warp][tt][s]
      float hs[kR + 1][4], dec[kR][4];     // hs[tt + 1] = h at step tt
#pragma unroll
      for (int j = 0; j < 4; ++j) hs[0][j] = hst[(sub * 4 + j) * kThreads + tid];
#pragma unroll
      for (int tt = 0; tt < kR; ++tt) {
        const int k = sub * kR + tt;
        const float dtv = sm.dt[k * kCPB + ch];
        const float u = dtv * sm.x[k * kCPB + ch];
        const float gyv = sm.gy[k * kCPB + ch];
        float bv[4], v[4];
        ld4(bv, sm.b + k * kDS + s0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dec[tt][j] = decay(dtv, rate2[j]);
          hs[tt + 1][j] = fmaf(dec[tt][j], hs[tt][j], u * bv[j]);
          v[j] = gyv * hs[tt + 1][j];       // dC's term
        }
        channel_sum<kG>(v, lane);
        if (slot.writer) {
#pragma unroll
          for (int o = 0; o < SumSlot<kG>::kOut; ++o) {
            rows[T::kPart + (warp * kR + tt) * kDS + slot.state + o] = v[o];
          }
        }
      }
#pragma unroll
      for (int tt = kR - 1; tt >= 0; --tt) {
        const int k = sub * kR + tt, t = t0 + k;
        const float dtv = sm.dt[k * kCPB + ch];
        const float xv = sm.x[k * kCPB + ch];
        const float gyv = sm.gy[k * kCPB + ch];
        const float u = dtv * xv;
        float bv[4], cv[4], v[4];
        ld4(bv, sm.b + k * kDS + s0);
        ld4(cv, sm.c + k * kDS + s0);
        float du = 0.f, gdec = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float gt = fmaf(gyv, cv[j], g[j]);
          du = fmaf(gt, bv[j], du);
          const float ga = gt * hs[tt][j] * dec[tt][j];
          gdec = fmaf(rate[j], ga, gdec);
          dacc[j] = fmaf(dtv, ga, dacc[j]);
          v[j] = gt * u;                    // dB's term
          g[j] = dec[tt][j] * gt;
        }
#pragma unroll
        for (int off = kG / 2; off > 0; off /= 2) {
          du += __shfl_xor_sync(kFull, du, off);
          gdec += __shfl_xor_sync(kFull, gdec, off);
        }
        if (live && s0 == 0 && t < S) {
          const size_t r = ((size_t)b * S + t) * DI + d;
          dx[r] = du * dtv;
          ddt[r] = fmaf(du, xv, gdec);
        }
        channel_sum<kG>(v, lane);
        if (slot.writer) {
#pragma unroll
          for (int o = 0; o < SumSlot<kG>::kOut; ++o) {
            rows[(warp * kR + tt) * kDS + slot.state + o] = v[o];
          }
        }
      }
      __syncthreads();                      // the tile's warp rows are in
      // the block's sums: the warps' rows in warp order, into its partials
      for (int e = tid; e < 2 * kR * kDS; e += kThreads) {
        const int kind = e / (kR * kDS), tt = (e / kDS) % kR, ss = e % kDS;
        const int t = t0 + sub * kR + tt;
        if (t < S && ss < DS) {
          const float* src = rows + kind * T::kPart + tt * kDS + ss;
          float acc = 0.f;
#pragma unroll
          for (int q = 0; q < kWarps; ++q) acc += src[q * kR * kDS];
          (kind ? w.pdc : w.pdb)[(((size_t)b * nblk + blk) * S + t) * DS +
                                 ss] = acc;
        }
      }
      par ^= 1;
    }
  }
  store_state<4>(dh0 + row * DS, g, live, s0, DS);
  store_state<4>(w.pda + row * DS, dacc, live, s0, DS);
}

// the ordered sums: dB and dC over the blocks, Mamba-2's ddt over a head's
// channels, da over the rows (Mamba-2: and the head's channels, each
// channel's states summed by the main kernel); a thread an output, in
// index order
__global__ void selective_scan_bwd_reduce(Work w, float* __restrict__ ddt,
                                          float* __restrict__ da,
                                          float* __restrict__ db,
                                          float* __restrict__ dc, int B,
                                          int S, int DI, int DS, int NH,
                                          int HD, int nblk, int heads) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_bc = (size_t)B * S * DS;
  for (int k = 0; k < 2; ++k) {
    if (i < n_bc) {
      const float* p = k ? w.pdc : w.pdb;
      const size_t bi = i / ((size_t)S * DS), ts = i % ((size_t)S * DS);
      float acc = 0.f;
      for (int q = 0; q < nblk; ++q) {
        acc += p[(bi * nblk + q) * S * DS + ts];
      }
      (k ? dc : db)[i] = acc;
      return;
    }
    i -= n_bc;
  }
  if (heads) {
    const size_t n_dt = (size_t)B * S * NH;
    if (i < n_dt) {
      const size_t bt = i / NH, hh = i % NH;
      const float* p = w.pddt + bt * DI + hh * HD;
      float acc = 0.f;
      for (int q = 0; q < HD; ++q) acc += p[q];
      ddt[i] = acc;
      return;
    }
    i -= n_dt;
    if (i < (size_t)NH) {
      float acc = 0.f;
      for (int bb = 0; bb < B; ++bb) {
        const float* p = w.pda + (size_t)bb * DI + i * HD;
        for (int q = 0; q < HD; ++q) acc += p[q];
      }
      da[i] = acc;
    }
    return;
  }
  if (i < (size_t)DI * DS) {
    float acc = 0.f;
    for (int bb = 0; bb < B; ++bb) acc += w.pda[(size_t)bb * DI * DS + i];
    da[i] = acc;
  }
}

// the ordered sums' launch (selective_scan_bwd_reduce) after either design
int reduce(const Work& w, float* ddt, float* da, float* db, float* dc, int B,
           int S, int DI, int DS, int NH, int HD, int nblk, bool heads,
           cudaStream_t stream) {
  const size_t n = 2 * (size_t)B * S * DS
      + (heads ? (size_t)B * S * NH + NH : (size_t)DI * DS);
  const int threads = 256;
  selective_scan_bwd_reduce<<<(unsigned)((n + threads - 1) / threads),
                              threads, 0, stream>>>(
      w, ddt, da, db, dc, B, S, DI, DS, NH, HD, nblk, heads ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <int kDS>
int run_heads(const float* dt, const float* a, const float* x,
              const float* bg, const float* cg, const float* h0,
              const float* gy, const float* gh, float* ddt, float* da,
              float* dx, float* db, float* dc, float* dh0, float* ws, int B,
              int S, int DI, int DS, int NH, int HD, cudaStream_t stream) {
  constexpr int kNS = states_a_lane(kDS);
  const Work w = carve(ws, B, S, DI, DS, true);
  const int nblk = blocks_a_row(DI, DS, true);
  const size_t smem = sizeof(float) * (2 * kT * kDS
                                       + (size_t)kT * kThreads * (kNS + 1));
  auto kernel = selective_scan_bwd_kernel<kDS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nblk, B), kThreads, smem, stream>>>(
      dt, a, x, bg, cg, h0, gy, gh, dx, w.pddt, dh0, w, S, DI, DS, NH, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(w, ddt, da, db, dc, B, S, DI, DS, NH, HD, nblk, true,
                stream);
}

template <int kDS>
int run_tiles(const float* dt, const float* a, const float* x,
              const float* bg, const float* cg, const float* h0,
              const float* gy, const float* gh, float* ddt, float* da,
              float* dx, float* db, float* dc, float* dh0, float* ws, int B,
              int S, int DI, int DS, cudaStream_t stream) {
  using T = Tiles<kDS>;
  const Work w = carve(ws, B, S, DI, DS, false);
  const int nblk = blocks_a_row(DI, DS, false);
  const bool vec = DI % 4 == 0 && DS % 4 == 0
      && ((reinterpret_cast<uintptr_t>(dt) | reinterpret_cast<uintptr_t>(x)
           | reinterpret_cast<uintptr_t>(gy) | reinterpret_cast<uintptr_t>(bg)
           | reinterpret_cast<uintptr_t>(cg)) & 15) == 0;
  auto kernel = scan_bwd_tiles_kernel<kDS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nblk, B), kThreads, T::kSmem, stream>>>(
      dt, a, x, bg, cg, h0, gy, gh, dx, ddt, dh0, w, S, DI, DS, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(w, ddt, da, db, dc, B, S, DI, DS, 0, 0, nblk, false, stream);
}

template <bool kHeads>
int dispatch(const float* dt, const float* a, const float* x,
             const float* bg, const float* cg, const float* h0,
             const float* gy, const float* gh, float* ddt, float* da,
             float* dx, float* db, float* dc, float* dh0, float* ws, int B,
             int S, int DI, int DS, int NH, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || DI <= 0 || DS <= 0 || DS > 128
      || (kHeads && (NH <= 0 || DI % NH != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int HD = kHeads ? DI / NH : 0;
#define SCAN_BWD_RUN(KDS)                                                     \
  if constexpr (kHeads) {                                                     \
    return run_heads<KDS>(dt, a, x, bg, cg, h0, gy, gh, ddt, da, dx, db, dc,  \
                          dh0, ws, B, S, DI, DS, NH, HD, stream);             \
  } else {                                                                    \
    return run_tiles<KDS>(dt, a, x, bg, cg, h0, gy, gh, ddt, da, dx, db, dc,  \
                          dh0, ws, B, S, DI, DS, stream);                     \
  }
  switch (padded_state(DS)) {
    case 4: SCAN_BWD_RUN(4);
    case 8: SCAN_BWD_RUN(8);
    case 16: SCAN_BWD_RUN(16);
    case 32: SCAN_BWD_RUN(32);
    case 64: SCAN_BWD_RUN(64);
    default: SCAN_BWD_RUN(128);
  }
#undef SCAN_BWD_RUN
}

}  // namespace

// the workspace's float count for these sizes
extern "C" long long selective_scan_bwd_workspace(int B, int S, int DI,
                                                  int DS, int heads) {
  if (B <= 0 || S <= 0 || DI <= 0 || DS <= 0 || DS > 128) return 0;
  return static_cast<long long>(workspace_floats(B, S, DI, DS, heads != 0));
}

// inputs as the forward's, gy and gh the cotangents of y and h_last; writes
// ddt, da, dx, db, dc, dh0 (each shaped as its input); ws holds
// selective_scan_bwd_workspace(B, S, DI, DS, heads) floats
extern "C" int selective_scan_bwd_launch(
    const void* dt, const void* a, const void* x, const void* b,
    const void* c, const void* h0, const void* gy, const void* gh, void* ddt,
    void* da, void* dx, void* db, void* dc, void* dh0, void* ws, int B,
    int S, int DI, int DS, int NH, int heads, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  if (heads) {
    return dispatch<true>(f(dt), f(a), f(x), f(b), f(c), f(h0), f(gy), f(gh),
                          m(ddt), m(da), m(dx), m(db), m(dc), m(dh0), m(ws),
                          B, S, DI, DS, NH, st);
  }
  return dispatch<false>(f(dt), f(a), f(x), f(b), f(c), f(h0), f(gy), f(gh),
                         m(ddt), m(da), m(dx), m(db), m(dc), m(dh0), m(ws), B,
                         S, DI, DS, 0, st);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
