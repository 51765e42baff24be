"""Selective state-space blocks — port of ``src/repro/models/ssm.py``:
Mamba-1 (falcon-mamba) and Mamba-2 / SSD (zamba2).

The scan runs in ``kernels.selective_scan``, one op a call
(``ops.selective_scan`` for Mamba-1's per-channel decay,
``ops.selective_scan_heads`` for Mamba-2's per-head one): on the card the
hand kernel of ``kernels/csrc/selective_scan.cu`` (a thread a channel, its
state in registers, nothing of size (S, di, ds) in memory) or, for
Mamba-2's prefill and training (head and state widths multiples of 8 up to
64, S > 1), the chunked matrix (SSD) kernels of
``kernels/csrc/selective_scan_ssd.cu`` on the tensor cores; on the CPU the
plain version, which keeps the reference's chunking (the (chunk, di, ds)
decay and input tensors built one chunk at a time) and steps through each
chunk where the reference runs an associative scan; the two agree up to the
reassociation of f32 products and sums.  Its gradient is one op too
(``repro_torch::selective_scan_bwd`` / ``::selective_scan_heads_bwd``): on
the card the backward kernel of ``kernels/csrc/selective_scan_bwd.cu`` (a
reverse scan over states recomputed from stored chunk boundaries) or, at
S >= 20, the SSD backward, on the CPU the plain version rerun under autograd.

Decode (S=1) reuses the same cell with the carried state: the SSM's "KV
cache" is the O(1) (conv_state, ssm_state) pair.

The reference's hint points are kept (``shard_lib.param_hints``): the
identity on one device.  Inside ``activation_hints`` the blocks are
tensor-parallel over d_inner on "model" (``ssm_state_spec``): each rank
projects, convolves and scans its block of channels (Mamba-2: its block of
heads), from an ``in_proj`` gathered whole and sliced (its columns
interleave x / z, and Mamba-2's B / C / dt, which a contiguous shard would
mix); Mamba-1's ``x_proj`` is row-parallel, summed over "model"; Mamba-2's
gated norm sums its squares over "model"; ``out_proj`` is row-parallel
(``shard_lib.region_out``).  When d_inner (Mamba-2: the head count) does
not split, the block runs whole on every rank.

A carried state under the hints (serving) is this rank's shard, tagged
with its ``cache_shardings`` spec, which splits the widest state dim over
"model".  Where that is not the compute block (Mamba-2's conv state holds
x, B and C, of which a rank convolves its block of x and all of B and C;
its scan state may split along hd or ds) the state is gathered and sliced
into the compute layout, and the new state back into the stored one
(``shard_lib.reshard``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shard_lib
from repro_torch.kernels import ops
from repro_torch.models.layers import _dtype, normal, rms_norm

Params = Dict[str, torch.Tensor]

MAMBA2_HEAD_DIM = 64                 # zamba2's SSD head width, fixed


def init_mamba(generator: torch.Generator,
               cfg: ModelConfig) -> Tuple[Params, Dict]:
    """Mamba-1 block parameters (falcon-mamba geometry)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    ds = cfg.ssm_state
    dt_rank = max(di // 16, 1)
    conv = cfg.ssm_conv
    dt = _dtype(cfg)
    dev = generator.device
    p = {
        "in_proj": normal(generator, (d, 2 * di), d**-0.5, dt),
        "conv_w": normal(generator, (conv, di), conv**-0.5, dt),
        "x_proj": normal(generator, (di, dt_rank + 2 * ds), di**-0.5, dt),
        "dt_proj": normal(generator, (dt_rank, di), dt_rank**-0.5, dt),
        # the reference's own numpy draw, reproduced exactly
        "dt_bias": torch.tensor(
            np.log(np.expm1(np.random.default_rng(0).uniform(1e-3, 0.1, di))),
            dtype=torch.float32, device=dev),
        "a_log": torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                        device=dev).repeat(di, 1)),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": normal(generator, (di, d), di**-0.5, dt),
    }
    s = {
        "in_proj": ("embed", "mlp"),
        "conv_w": (None, "mlp"),
        "x_proj": ("mlp", None),
        "dt_proj": (None, "mlp"),
        "dt_bias": ("mlp",),
        "a_log": ("mlp", None),
        "d_skip": ("mlp",),
        "out_proj": ("mlp", "embed"),
    }
    return p, s


def selective_scan(
    dt_: torch.Tensor,      # (B, S, di) input-dependent step sizes
    a_mat: torch.Tensor,    # (di, ds) continuous-time decay (negative)
    xi: torch.Tensor,       # (B, S, di) inputs
    b_in: torch.Tensor,     # (B, S, ds) input gates
    c_in: torch.Tensor,     # (B, S, ds) output gates
    h0: torch.Tensor,       # (B, di, ds) initial state
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan, the reference's signature: h_t = exp(dt_t a) h_{t-1}
    + (dt_t xi_t) b_t, y_t = <h_t, c_t>.  Returns (y (B, S, di), h_last)
    (``ops.selective_scan``)."""
    return ops.selective_scan(dt_, a_mat, xi, b_in, c_in, h0, chunk)


def _causal_conv(xs: torch.Tensor, conv_w: torch.Tensor, state, conv: int):
    """Depthwise causal conv1d over (B, S, width) with the carried
    (B, conv-1, width) inputs; returns (silu(conv), new conv state: the last
    conv-1 padded inputs)."""
    bsz, s, width = xs.shape
    if state is not None:
        pad = torch.cat([state.to(xs.dtype), xs], dim=1)
    else:
        pad = F.pad(xs, (0, 0, conv - 1, 0))
    new_state = pad[:, pad.shape[1] - (conv - 1):, :] if conv > 1 else \
        xs.new_zeros((bsz, 0, width))
    xw = pad.unfold(1, conv, 1)                          # (B, S, width, conv)
    return F.silu((xw * conv_w.T).sum(-1)), new_state


def mamba(
    p: Params,
    x: torch.Tensor,                      # (B, S, d)
    cfg: ModelConfig,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    chunk: int = 256,
    sp: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Mamba-1 selective SSM. ``state = (conv_state (B, conv-1, di),
    ssm_state (B, di, ds))`` enables stateful decode. Returns (y, new_state).
    """
    di = cfg.ssm_expand * x.shape[-1]
    ds = cfg.ssm_state
    dt_rank = max(di // 16, 1)
    p = shard_lib.param_hints(p, MAMBA_SPECS)
    ax = shard_lib.mesh_axis("model")
    split = ax is not None and di % ax.size == 0
    if split:
        di_l = di // ax.size
        w_in = shard_lib.whole(p["in_proj"])
        lo = ax.rank * di_l
        p = dict(p, in_proj=torch.cat([w_in[:, lo:lo + di_l],
                                       w_in[:, di + lo:di + lo + di_l]], 1))
        di = di_l
    elif ax is not None:
        p = {k: shard_lib.whole(w, "slice") for k, w in p.items()}
    # the states' stored split dims, and their compute ones
    at = (None, None) if state is None else tuple(
        shard_lib.model_dim(t) for t in state)
    here = (2, 1) if split else (None, None)
    if state is not None:
        state = tuple(shard_lib.reshard(t, a, h)
                      for t, a, h in zip(state, at, here))
    x = shard_lib.region_in(x, split, sp)
    bsz, s, d = x.shape

    xz = x @ p["in_proj"]                               # (B, S, 2di)
    xi, z = xz[..., :di], xz[..., di:]
    xi, new_conv_state = _causal_conv(
        xi, p["conv_w"], None if state is None else state[0], cfg.ssm_conv)

    # input-dependent SSM parameters, (B, S, dt_rank + 2ds); x_proj is
    # row-parallel
    proj = (shard_lib.summed_product(xi, p["x_proj"], grad="sum")
            if split else xi @ p["x_proj"])
    dt_in = proj[..., :dt_rank]
    b_in = proj[..., dt_rank : dt_rank + ds].float()
    c_in = proj[..., dt_rank + ds :].float()
    dt_ = F.softplus((dt_in @ p["dt_proj"]).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])                          # (di, ds)
    xf = xi.float()

    h0 = (state[1].float() if state is not None
          else torch.zeros((bsz, di, ds), dtype=torch.float32,
                           device=x.device))
    y, h_last = ops.selective_scan(dt_, a, xf, b_in, c_in, h0, chunk)
    y = y + xf * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    out = shard_lib.row_out(y, p["out_proj"], split, sp)
    new = (new_conv_state, h_last.float())
    return out, tuple(shard_lib.reshard(t, h, a)
                      for t, h, a in zip(new, here, at))


def init_mamba2(generator: torch.Generator,
                cfg: ModelConfig) -> Tuple[Params, Dict]:
    """Mamba-2 (SSD) block: scalar decay per head; B/C shared across head dims
    (geometry follows zamba2: d_inner = expand*d, head_dim 64)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    ds = cfg.ssm_state
    nh = di // MAMBA2_HEAD_DIM
    conv = cfg.ssm_conv
    dt = _dtype(cfg)
    dev = generator.device

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    p = {
        "in_proj": normal(generator, (d, 2 * di + 2 * ds + nh), d**-0.5, dt),
        "conv_w": normal(generator, (conv, di + 2 * ds), conv**-0.5, dt),
        "dt_bias": zeros(nh),
        "a_log": zeros(nh),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm_w": zeros(di),
        "out_proj": normal(generator, (di, d), di**-0.5, dt),
    }
    s = {
        "in_proj": ("embed", "mlp"),
        "conv_w": (None, "mlp"),
        "dt_bias": (None,),
        "a_log": (None,),
        "d_skip": (None,),
        "norm_w": ("mlp",),
        "out_proj": ("mlp", "embed"),
    }
    return p, s


def mamba2(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    chunk: int = 256,
    sp: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Mamba-2 / SSD with scalar per-head decay. State:
    (conv_state (B, conv-1, di+2ds), ssm_state (B, nh, hd, ds))."""
    di = cfg.ssm_expand * x.shape[-1]
    ds = cfg.ssm_state
    hd = MAMBA2_HEAD_DIM
    nh = di // hd
    p = shard_lib.param_hints(p, MAMBA2_SPECS)
    ax = shard_lib.mesh_axis("model")
    split = ax is not None and nh % ax.size == 0
    di_all = di
    # the states' stored split dims (the conv state's compute layout is
    # x's block with B and C whole; the scan state's, the heads' block)
    at = (None, None) if state is None else tuple(
        shard_lib.model_dim(t) for t in state)
    if split:
        nh_l = nh // ax.size
        di_l = nh_l * hd
        lo = ax.rank * di_l
        w_in, conv_w = shard_lib.whole(p["in_proj"]), shard_lib.whole(
            p["conv_w"])
        bc = slice(2 * di, 2 * di + 2 * ds)
        h0_ = 2 * di + 2 * ds + ax.rank * nh_l
        p = dict(
            p,
            in_proj=torch.cat([w_in[:, lo:lo + di_l],
                               w_in[:, di + lo:di + lo + di_l], w_in[:, bc],
                               w_in[:, h0_:h0_ + nh_l]], 1),
            conv_w=torch.cat([conv_w[:, lo:lo + di_l],
                              conv_w[:, di:di + 2 * ds]], 1),
            norm_w=shard_lib.local_block(p["norm_w"], 0, di_l),
            **{k: shard_lib.local_block(p[k], 0, nh_l)
               for k in ("dt_bias", "a_log", "d_skip")})
        di, nh = di_l, nh_l
    elif ax is not None:
        p = {k: shard_lib.whole(w, "slice") for k, w in p.items()}
    if state is not None:
        conv_st = shard_lib.reshard(state[0], at[0], None)
        if split:
            conv_st = torch.cat([conv_st[..., lo:lo + di],
                                 conv_st[..., di_all:]], -1)
        state = (conv_st, shard_lib.reshard(state[1], at[1],
                                            1 if split else None))
    x = shard_lib.region_in(x, split, sp)
    bsz, s, d = x.shape

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : di + di + 2 * ds]
    dt_in = zxbcdt[..., zxbcdt.shape[-1] - nh:]
    xbc, new_conv_state = _causal_conv(
        xbc, p["conv_w"], None if state is None else state[0], cfg.ssm_conv)

    xif = xbc[..., :di].float()                             # (B, S, di)
    b_in = xbc[..., di : di + ds].float()                   # (B, S, ds)
    c_in = xbc[..., di + ds :].float()                      # (B, S, ds)
    dt_h = F.softplus(dt_in.float() + p["dt_bias"])         # (B, S, nh)
    # the scalar per-head decay, scanned per head (the reference repeats
    # it over the head's channels and states for the shared scan: the same
    # products)
    h0 = (state[1].float() if state is not None
          else torch.zeros((bsz, nh, hd, ds), dtype=torch.float32,
                           device=x.device))
    y, h_last = ops.selective_scan_heads(
        dt_h, -torch.exp(p["a_log"]), xif, b_in, c_in,
        h0.reshape(bsz, di, ds), chunk)
    y = y + xif * p["d_skip"].repeat_interleave(hd)
    y = y.to(x.dtype)
    if split:
        y = _rms_norm_split(y * F.silu(z), p["norm_w"], cfg.norm_eps,
                            di * ax.size)
    else:
        y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = shard_lib.row_out(y, p["out_proj"], split, sp)
    h_last = h_last.reshape(bsz, nh, hd, ds).float()
    if state is not None:
        if split:
            new_conv_state = torch.cat([
                shard_lib.gather(new_conv_state[..., :di], 2),
                new_conv_state[..., di:]], -1)
        new_conv_state = shard_lib.reshard(new_conv_state, None, at[0])
        h_last = shard_lib.reshard(h_last, 1 if split else None, at[1])
    return out, (new_conv_state, h_last)


def _rms_norm_split(x: torch.Tensor, w: torch.Tensor, eps: float,
                    width: int) -> torch.Tensor:
    """``rms_norm`` over a last dim of ``width`` split over "model": the
    squares are summed over the ranks."""
    dt = x.dtype
    x32 = x.float()
    ss = shard_lib.all_reduce((x32 * x32).sum(-1, keepdim=True), grad="sum")
    return ((x32 * torch.rsqrt(ss / width + eps)) * (1.0 + w.float())).to(dt)


MAMBA_SPECS = {"in_proj": ("embed", "mlp"), "conv_w": (None, "mlp"),
               "x_proj": ("mlp", None), "dt_proj": (None, "mlp"),
               "dt_bias": ("mlp",), "a_log": ("mlp", None),
               "d_skip": ("mlp",), "out_proj": ("mlp", "embed")}
MAMBA2_SPECS = {"in_proj": ("embed", "mlp"), "conv_w": (None, "mlp"),
                "dt_bias": (None,), "a_log": (None,), "d_skip": (None,),
                "norm_w": ("mlp",), "out_proj": ("mlp", "embed")}
