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
// small) at zamba2's shapes; at falcon-mamba's the B * S * DI * DS exps,
// which this kernel takes four times (below).
//
// Design (simple first).  h_{t-1} is never recovered by dividing by A_t,
// which underflows; it is recomputed forward from stored states, and
// nothing of size (S, DI, DS) is ever in memory:
//  * a channel's DS states are split over kG lanes of kNS states each (kNS
//    of 4, 8 or 16: 8 at zamba2's 64, so two blocks fit an SM's
//    registers), so a block of 256 threads holds 256 / kG channels (kCPB)
//    of one batch row;
//  * pass 1 runs the forward and stores the state at the start of every
//    kChunk steps, (B, ceil(S / kChunk), DI, DS) (padded to the blocks'
//    lanes and laid out lane-fastest, so a warp's stores are coalesced);
//  * the chunks are walked in reverse.  Pass 2 reruns a chunk from its
//    stored state and stores the state at the start of each of its kT-step
//    tiles, (B, kChunk / kT, DI, DS) (the same layout); pass 3 walks the
//    tiles in reverse:
//    it reruns a tile from its stored state into registers (kT + 1 states
//    of kNS values), then steps back through it, carrying g in registers.
//    So every A_t is formed four times;
//  * sums over a channel's lanes (du, ddt) are xor shuffles within its kG
//    lanes; sums over channels (dB, dC) go through shared memory a tile at a
//    time, summed over the block's channels in order, into per-block
//    partials (B, nblk, S, DS); da's per (b, d, s) partials (Mamba-2: per
//    (b, d)), Mamba-2's per-channel ddt and the partials are summed by a
//    second kernel in a fixed order.  No float atomics: two runs give the
//    same bits.
// The stored states and partials live in one workspace that the caller
// allocates (selective_scan_bwd_workspace gives its float count).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a block
constexpr int kT = 4;           // steps a register tile
constexpr int kChunk = 128;     // steps between the states pass 1 stores
constexpr int kTiles = kChunk / kT;
constexpr unsigned kFull = 0xffffffffu;

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

// the workspace's parts, in floats: the chunk starts, the tile starts (each
// a state of every block's lanes), the dB and dC partials, da's and
// (Mamba-2) ddt's per-channel terms
void parts(size_t (&n)[6], int B, int S, int DI, int DS, bool heads) {
  const size_t nc = (S + kChunk - 1) / kChunk;
  const size_t nblk = (DI + channels_a_block(DS) - 1) / channels_a_block(DS);
  const size_t state = (size_t)DI * DS;
  const size_t lanes = nblk * kThreads
      * states_a_lane(padded_state(DS));        // a padded state
  n[0] = B * nc * lanes;
  n[1] = B * kTiles * lanes;
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

// one forward step of a lane's kNS states (the forward kernel's arithmetic)
template <int kNS, bool kHeads>
__device__ __forceinline__ void step(float (&out)[kNS], const float (&in)[kNS],
                                     const float* sb, float dtv, float u,
                                     const float* rate) {
  const float head_decay = kHeads ? expf(dtv * rate[0]) : 0.f;
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    const float decay =
        kHeads ? head_decay : expf(dtv * rate[kHeads ? 0 : j]);
    out[j] = fmaf(decay, in[j], u * sb[j]);
  }
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

template <int kDS, bool kHeads>
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
  const int head = (kHeads && live) ? d / HD : 0;
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

  float rate[kHeads ? 1 : kNS];
  if constexpr (kHeads) {
    rate[0] = live ? a[head] : 0.f;
  } else {
    load_state<kNS>(rate, a + (size_t)d * DS, live, s0, DS);
  }

  // a tile's per-channel inputs, into registers; its B (and C) rows into
  // shared memory
  float dl[kT], xl[kT], gl[kT];
  auto load_tile = [&](int t0, int nt, bool grad) {
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      const bool in = live && tt < nt;
      const size_t r = ((size_t)b * S + t0 + tt) * DI + d;
      dl[tt] = in ? (kHeads ? dt[((size_t)b * S + t0 + tt) * NH + head]
                            : dt[r]) : 0.f;
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
        step<kNS, kHeads>(h, h, sb + tt * kDS + s0, dl[tt], dl[tt] * xl[tt],
                          rate);
      }
    }
  }

  // the reverse walk
  float g[kNS];
  load_state<kNS>(g, gh + row * DS, live, s0, DS);
  float dacc[kHeads ? 1 : kNS];
#pragma unroll
  for (int j = 0; j < (kHeads ? 1 : kNS); ++j) dacc[j] = 0.f;
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
        step<kNS, kHeads>(h, h, sb + tt * kDS + s0, dl[tt], dl[tt] * xl[tt],
                          rate);
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
          step<kNS, kHeads>(hs[tt + 1], hs[tt], sb + tt * kDS + s0, dl[tt],
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
          const float head_decay = kHeads ? expf(dl[tt] * rate[0]) : 0.f;
          float du = 0.f, gdec = 0.f;
#pragma unroll
          for (int j = 0; j < kNS; ++j) {
            const float gt = fmaf(gl[tt], ct[j], g[j]);
            du = fmaf(gt, bt[j], du);
            const float decay =
                kHeads ? head_decay : expf(dl[tt] * rate[kHeads ? 0 : j]);
            const float ga = gt * hs[tt][j] * decay;
            if constexpr (kHeads) {
              gdec += ga;
            } else {
              gdec = fmaf(rate[j], ga, gdec);
              dacc[j] = fmaf(dl[tt], ga, dacc[j]);
            }
            myred[tt * kThreads * kRed + j] = gt * u;     // dB's term
            g[j] = decay * gt;
          }
          if constexpr (kHeads) {
            dacc[0] = fmaf(dl[tt], gdec, dacc[0]);
            gdec *= rate[0];
          }
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
  if constexpr (kHeads) {
    // the channel's share of da: its lanes' summed, at (b, d)
#pragma unroll
    for (int off = kG / 2; off > 0; off /= 2) {
      dacc[0] += __shfl_xor_sync(kFull, dacc[0], off);
    }
    if (live && lane == 0) w.pda[row] = dacc[0];
  } else {
    store_state<kNS>(w.pda + row * DS, dacc, live, s0, DS);
  }
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

template <int kDS, bool kHeads>
int run(const float* dt, const float* a, const float* x, const float* bg,
        const float* cg, const float* h0, const float* gy, const float* gh,
        float* ddt, float* da, float* dx, float* db, float* dc, float* dh0,
        float* ws, int B, int S, int DI, int DS, int NH, int HD,
        cudaStream_t stream) {
  constexpr int kNS = states_a_lane(kDS);
  constexpr int kCPB = kThreads / (kDS / kNS);
  const Work w = carve(ws, B, S, DI, DS, kHeads);
  const int nblk = (DI + kCPB - 1) / kCPB;
  const size_t smem = sizeof(float) * (2 * kT * kDS
                                       + (size_t)kT * kThreads * (kNS + 1));
  auto kernel = selective_scan_bwd_kernel<kDS, kHeads>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nblk, B), kThreads, smem, stream>>>(
      dt, a, x, bg, cg, h0, gy, gh, dx, kHeads ? w.pddt : ddt, dh0, w, S, DI,
      DS, NH, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = 2 * (size_t)B * S * DS
      + (kHeads ? (size_t)B * S * NH + NH : (size_t)DI * DS);
  const int threads = 256;
  selective_scan_bwd_reduce<<<(unsigned)((n + threads - 1) / threads),
                              threads, 0, stream>>>(
      w, ddt, da, db, dc, B, S, DI, DS, NH, HD, nblk, kHeads ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
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
  return run<KDS, kHeads>(dt, a, x, bg, cg, h0, gy, gh, ddt, da, dx, db, dc, \
                          dh0, ws, B, S, DI, DS, NH, HD, stream)
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
