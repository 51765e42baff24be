"""Transformer building blocks — port of ``src/repro/models/layers.py``:
RMSNorm, RoPE, GQA/SWA attention (KV cache, ring buffer, query chunks),
SwiGLU / GELU MLP and capacity-based MoE.

Every function is a plain function over tensors with the reference's name
and argument order; weights come in as dicts of tensors, made by the
matching ``init_*`` function, which also returns the *logical sharding spec*
of each weight (axis names the training slice's sharding resolves to mesh
axes).  ``init_*`` take a ``torch.Generator`` where the reference takes a
PRNG key: the shapes, scales and dtypes are the reference's, the values are
other draws from the same distributions.

The reference's hint points are kept (``shard_lib.param_hints``): outside
``activation_hints`` they are the identity and each function runs the ops
it runs on one device.  Inside it (``train.loop``'s sharded step) the
weights are each rank's local shards and the layers are tensor-parallel
over "model", Megatron's way: q / k / v / the MLP's inputs / d_inner /
experts column-parallel with no collective, ``wo`` and the down
projections row-parallel with their outputs summed over "model" (``sp``:
reduce-scattered along the sequence, the input all-gathered), inside
``shard_lib.region_in`` / ``region_out``.  A rank's q heads are a
contiguous block of ``wq``'s columns, each mapped to its kv head ``h //
g``; where kv heads do not split over "model" (GQA / MQA) the rank uses
the kv heads its q heads need.  A layer whose dims do not split (the
divisibility fallback) runs whole on every rank, its weights gathered.
``moe``'s capacity and slot positions are the global ones (the routing is
gathered over "data"), and ``dispatch_hint`` splits the expert buffer's
capacity slots over "data" (``moe_out_spec``).  Serving under the hints
(``train.loop.make_serve_step``) runs ``attention`` on this rank's shard
of the KV cache, laid out by ``cache_shardings``; where the batch is whole
on every rank (``batch_split=False``) ``moe`` routes as on one device; a
row-parallel output's partial sums are added in f32
(``shard_lib.row_out``).

Logical axis vocabulary:
    "embed"   — d_model
    "heads"   — attention heads
    "kv"      — kv heads
    "mlp"     — FFN hidden
    "vocab"   — vocabulary
    "experts" — MoE experts
    None      — replicated

Numerics kept from the reference, each of which the natural PyTorch form
would change: RMSNorm scales by ``1 + w`` in f32; RoPE rotates the two
halves of a head, not interleaved pairs; attention logits are f32, soft-capped
when ``logit_softcap`` is set, masked with -1e30 (not -inf), and the softmax
weights are cast to V's dtype before the PV product; GELU is the tanh form
(``jax.nn.gelu``'s default); MoE's top-k keeps the lower expert first on ties
(a stable descending sort, not ``torch.topk``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shard_lib

Params = Dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config's ``dtype`` string names."""
    return _DTYPES[name]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def normal(generator: torch.Generator, shape, scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 on the generator's device, then cast —
    the reference's ``(jax.random.normal(k, shape) * scale).astype(dt)``."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norm / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs           # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA / SWA), chunked over query blocks
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator,
                   cfg: ModelConfig) -> Tuple[Params, Dict]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    scale = d ** -0.5
    dt = _dtype(cfg)
    p = {
        "wq": normal(generator, (d, nq * hd), scale, dt),
        "wk": normal(generator, (d, nkv * hd), scale, dt),
        "wv": normal(generator, (d, nkv * hd), scale, dt),
        "wo": normal(generator, (nq * hd, d), (nq * hd) ** -0.5, dt),
    }
    s = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv"),
        "wv": ("embed", "kv"),
        "wo": ("heads", "embed"),
    }
    return p, s


ATTN_SPECS = {"wq": ("embed", "heads"), "wk": ("embed", "kv"),
              "wv": ("embed", "kv"), "wo": ("heads", "embed")}


class HeadPlan(NamedTuple):
    """How a rank runs attention: its weights (``wq`` / ``wo`` for its q
    heads, ``wk`` / ``wv`` for the kv heads it projects), its q heads, the
    kv heads it projects, the block ``(first, count)`` of those its q heads
    attend to (None: all), and whether the work is split over "model"."""
    w: Params
    nq: int
    nkv: int
    kv_sel: Optional[Tuple[int, int]]
    split: bool


def head_plan(p: Params, cfg: ModelConfig) -> HeadPlan:
    """The ``HeadPlan`` of hinted attention weights ``p``: every head on
    one device; inside ``activation_hints`` a contiguous block of q heads
    per "model" rank when the heads split (their kv heads with them, or
    whole kv projections when the kv heads do not split), else the whole
    attention on every rank."""
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    ax = shard_lib.mesh_axis("model")
    if ax is None:
        return HeadPlan(p, nq, nkv, None, False)
    m, g = ax.size, nq // nkv

    def whole():
        return HeadPlan({k: shard_lib.whole(w, "slice")
                         for k, w in p.items()}, nq, nkv, None, False)

    if nq % m or shard_lib.model_dim(p["wq"]) != 1:
        return whole()
    nq_l = nq // m
    if nkv % m == 0 and shard_lib.model_dim(p["wk"]) == 1:
        return HeadPlan(p, nq_l, nkv // m, None, True)
    if nq_l % g == 0:
        n_kv = nq_l // g
    elif g % nq_l == 0:
        n_kv = 1
    else:
        return whole()
    w = dict(p, wk=shard_lib.whole(p["wk"]), wv=shard_lib.whole(p["wv"]))
    return HeadPlan(w, nq_l, nkv, (ax.rank * nq_l // g, n_kv), True)


def _attn_mask(q_pos, k_pos, sliding_window: int, prefix_len: int = 0):
    """(..., Sq, Sk) boolean mask from (..., Sq) and (..., Sk) positions.
    Causal, optional sliding window, optional bidirectional prefix
    (PaliGemma-style prefix-LM)."""
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    causal = qp >= kp
    if prefix_len > 0:
        causal = causal | ((qp < prefix_len) & (kp < prefix_len))
    if sliding_window > 0:
        causal = causal & (qp - kp < sliding_window)
    return causal


def attention(
    p: Params,
    x: torch.Tensor,                  # (B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,          # (B, S)
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len: Optional[int] = None,
    q_chunk: int = 1024,
    prefix_len: int = 0,
    attend_cache: bool = False,
    sp: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """GQA attention. With ``kv_cache=(k,v)`` of shape (B, C, Hkv, hd) this is
    a decode/prefill-extend step: new k/v are written at ``cache_len`` (a
    host int) and attention runs over the cache. Returns (out, new_cache);
    the new cache is a new pair of tensors, the caller's are not written.
    ``sp``: ``x`` and the output are sequence-parallel (``positions`` cover
    the whole sequence).

    Inside ``activation_hints`` the cache is this rank's shard, tagged with
    its ``cache_shardings`` spec (batch, positions, kv heads, hd), which
    sets the layout: kv heads over "model" (each rank its heads' slice,
    the heads' own region), or positions split over "model" and / or
    "data" (each rank holds a contiguous block of slots of every kv head;
    a write lands on the rank that owns the slot, and attention over the
    cache combines the ranks' softmax sums: ``_softmax_pv``).  Where the q
    heads split over "model" and the positions do too, a rank gathers
    every q head, attends them over its slice, and keeps its own heads'
    output for its ``wo`` block."""
    hp = head_plan(shard_lib.param_hints(p, ATTN_SPECS), cfg)
    p = hp.w
    x = shard_lib.region_in(x, hp.split, sp)
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = hp.nq, hp.nkv

    q = (x @ p["wq"]).reshape(b, s, nq, hd)
    k = (x @ p["wk"]).reshape(b, s, nkv, hd)
    v = (x @ p["wv"]).reshape(b, s, nkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    seq = ()                     # the mesh axes the attended positions span
    if kv_cache is not None:
        ck, cv = kv_cache
        spec = getattr(ck, "_shard_spec", None)
        pseq = spec[1] if spec is not None else None
        n_blk, blk = shard_lib.split_of(pseq)
        cap_l = ck.shape[1]
        cap = cap_l * n_blk
        ring = cfg.sliding_window > 0 and cap <= 2 * cfg.sliding_window
        if s > cap and not ring:
            raise ValueError(
                f"prefill length {s} exceeds non-ring cache capacity {cap}"
            )
        # write the (last cap) new k/v into the slots this rank holds.
        # Slots are pos % cap in ring mode; no slot is written twice.
        runs = _kv_writes(cache_len, s, cap, ring, blk * cap_l, cap_l)
        if runs:
            src, dst = _runs_index(runs, x.device)
            kw = k.narrow(1, *src) if isinstance(src, tuple) else \
                k.index_select(1, src)
            vw = v.narrow(1, *src) if isinstance(src, tuple) else \
                v.index_select(1, src)
            ck = ck.index_copy(1, dst, kw.to(ck.dtype))
            cv = cv.index_copy(1, dst, vw.to(cv.dtype))
        new_cache = (ck, cv)
        if s > 1 and not attend_cache:
            # single-shot prefill: attend over the in-flight k/v (window mask
            # applies); the cache is only written for subsequent decode steps
            k_all, v_all = k, v
            k_pos_all = positions
        else:
            # decode, or segmented (chunked) prefill: attend over the cache
            # (already containing this segment's keys); absolute-position
            # masking handles both full and ring buffers
            k_all, v_all = ck, cv
            k_pos_all = _cache_positions(cache_len, s, cap, ring, x.device,
                                         blk * cap_l, cap_l)
            seq = shard_lib.live_axes(pseq)
    else:
        k_all, v_all = k, v
        k_pos_all = positions

    own = None
    if hp.kv_sel is not None:
        if "model" in seq:
            # every q head attends this rank's positions: gather them
            q = shard_lib.gather(q, 2, "model")
            own = (shard_lib.mesh_axis("model").rank * nq, nq)
            nq = q.shape[2]
        else:
            k_all = k_all.narrow(2, *hp.kv_sel)
            v_all = v_all.narrow(2, *hp.kv_sel)
            nkv = hp.kv_sel[1]
    g = nq // nkv
    # grouped heads: (B, S, Hkv, G, hd)
    qg = q.reshape(b, s, nkv, g, hd)
    k_pos_all = k_pos_all.expand(b, k_pos_all.shape[-1])
    k32 = k_all.float()
    scale = hd ** -0.5

    def attend_chunk(q_blk, qpos_blk):
        # q_blk (B, sq, Hkv, G, hd)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", q_blk.float(), k32) * scale
        if cfg.logit_softcap > 0:
            c = cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        mask = _attn_mask(qpos_blk, k_pos_all, cfg.sliding_window, prefix_len)
        logits = logits.masked_fill(~mask[:, None, None], -1e30)
        if seq:
            return _softmax_pv(logits, v_all, seq)
        w = torch.softmax(logits, dim=-1)
        return torch.einsum("bhgqk,bkhd->bqhgd", w.to(v_all.dtype), v_all)

    if s > q_chunk and s % q_chunk == 0:
        out = torch.cat([
            attend_chunk(qg[:, i : i + q_chunk], positions[:, i : i + q_chunk])
            for i in range(0, s, q_chunk)], dim=1)
    else:
        out = attend_chunk(qg, positions)
    out = out.reshape(b, s, nq, hd)
    if own is not None:
        out, nq = out.narrow(2, *own), own[1]
    return shard_lib.row_out(out.reshape(b, s, nq * hd), p["wo"], hp.split,
                             sp), new_cache


def _softmax_pv(logits: torch.Tensor, v: torch.Tensor,
                axes: Tuple[str, ...]) -> torch.Tensor:
    """``softmax(logits) @ v`` with the positions (the last dim of the
    logits, dim 1 of ``v``) split over the mesh ``axes``, the one-rank
    numerics kept: the row max and the sum of exponentials taken over every
    rank, each weight ``exp(l - max) / sum`` cast to V's dtype as one rank
    casts it, the rank's partial products summed over the axes in f32 and
    cast once."""
    mx = logits.amax(-1, keepdim=True)
    for a in axes:
        mx = shard_lib.all_reduce_max(mx, a)
    e = torch.exp(logits - mx)
    den = e.sum(-1, keepdim=True)
    for a in axes:
        den = shard_lib.all_reduce(den, a)
    w = (e / den).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.float(), v.float())
    for a in axes:
        out = shard_lib.all_reduce(out, a)
    return out.to(v.dtype)


def _kv_writes(cache_len: int, s: int, cap: int, ring: bool, first: int,
               count: int):
    """Where a step's new k/v rows go: [(row, local slot, n)] runs of the
    last ``min(s, cap)`` rows, at slots ``cache_len + row`` (``% cap`` in a
    ring), that fall in this rank's slots ``[first, first + count)``."""
    w = min(s, cap)
    base = cache_len + s - w            # the first written row's position
    if not ring and base + w > cap:
        raise ValueError(f"cache of {cap} slots overflows at "
                         f"{base + w} positions")
    g0 = base % cap if ring else base
    n0 = min(w, cap - g0)
    runs = [(s - w, g0, n0)] + ([(s - w + n0, 0, w - n0)] if w > n0 else [])
    out = []
    for row, g, n in runs:
        lo, hi = max(g, first), min(g + n, first + count)
        if lo < hi:
            out.append((row + lo - g, lo - first, hi - lo))
    return out


def _runs_index(runs, device):
    """(the source rows — ``(start, n)`` for one run, else an index —, the
    destination slots) of ``_kv_writes``' runs."""
    def ar(a, n):
        return torch.arange(a, a + n, device=device)

    if len(runs) == 1:
        row, slot, n = runs[0]
        return (row, n), ar(slot, n)
    return (torch.cat([ar(r, n) for r, _, n in runs]),
            torch.cat([ar(sl, n) for _, sl, n in runs]))


def _cache_positions(cache_len: int, s_new: int, cap: int, ring: bool,
                     device=None, first: int = 0,
                     count: Optional[int] = None) -> torch.Tensor:
    """(1, count) absolute positions held in slots ``[first, first +
    count)`` of the cache (all ``cap`` by default), for masking."""
    count = cap - first if count is None else count
    slot = torch.arange(first, first + count, device=device)
    total = cache_len + s_new
    if ring:
        # ring buffer: slot i holds the largest position p < total with
        # p % cap == i; slots not yet written get a huge position (masked).
        pos = slot + torch.div(total - 1 - slot, cap,
                               rounding_mode="floor") * cap
        pos = torch.where((pos < total) & (pos >= 0), pos, 2**30)
        return pos[None, :]
    return torch.where(slot < total, slot, 2**30)[None, :]


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Tuple[Params, Dict]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = _dtype(cfg)
    if cfg.mlp_variant == "gelu":
        p = {
            "wi_up": normal(generator, (d, f), d**-0.5, dt),
            "wo": normal(generator, (f, d), f**-0.5, dt),
        }
        s = {"wi_up": ("embed", "mlp"), "wo": ("mlp", "embed")}
        return p, s
    p = {
        "wi_gate": normal(generator, (d, f), d**-0.5, dt),
        "wi_up": normal(generator, (d, f), d**-0.5, dt),
        "wo": normal(generator, (f, d), f**-0.5, dt),
    }
    s = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
         "wo": ("mlp", "embed")}
    return p, s


MLP_SPECS = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
             "wo": ("mlp", "embed")}


def mlp(p: Params, x: torch.Tensor, sp: bool = False) -> torch.Tensor:
    """SwiGLU (or GELU) MLP; inside ``activation_hints`` column-parallel
    in, row-parallel out when the hidden dim splits over "model"."""
    p = shard_lib.param_hints(p, MLP_SPECS)
    split = shard_lib.model_dim(p["wi_up"]) == 1
    x = shard_lib.region_in(x, split, sp)
    if "wi_gate" not in p:
        h = F.gelu(x @ p["wi_up"], approximate="tanh")
    else:
        h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    return shard_lib.row_out(h, p["wo"], split, sp)


def init_moe(generator: torch.Generator,
             cfg: ModelConfig) -> Tuple[Params, Dict]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = _dtype(cfg)
    p = {
        "router": normal(generator, (d, e), d**-0.5, torch.float32),
        "wi_gate": normal(generator, (e, d, f), d**-0.5, dt),
        "wi_up": normal(generator, (e, d, f), d**-0.5, dt),
        "wo": normal(generator, (e, f, d), f**-0.5, dt),
    }
    s = {
        "router": ("embed", None),
        "wi_gate": ("experts", "embed", "mlp"),
        "wi_up": ("experts", "embed", "mlp"),
        "wo": ("experts", "mlp", "embed"),
    }
    return p, s


def moe_route(p: Params, xt: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25) -> Dict[str, torch.Tensor]:
    """The router of ``moe`` over (T, d) tokens: softmax probabilities, the
    top-k experts (ties to the lower expert) and their renormalised gates,
    the capacity ``cap``, and each (token, choice)'s slot ``dest`` =
    expert * cap + position (``e * cap`` where it overflowed, ``keep``
    False).  Positions count the (token, choice) pairs in token-major order.
    Inside ``activation_hints`` the tokens are this "data" rank's and the
    order is the global one: ``cap`` comes from the global token count and
    the positions from a cumsum over every rank's choices, gathered over
    "data" (a rank's own ``cap`` would drop other tokens)."""
    t = xt.shape[0]
    e, kk = cfg.num_experts, cfg.experts_per_token
    dat = shard_lib.batch_axis("data")
    nd, j = (dat.size, dat.rank) if dat is not None else (1, 0)
    logits = xt.float() @ p["router"]                           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :kk], gate_idx[:, :kk]   # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    cap = max(int(math.ceil(t * nd * kk / e * capacity_factor)), 4)
    flat_idx = gate_idx.reshape(-1)                             # (T*k,)
    with torch.no_grad():
        every = (shard_lib.gather(flat_idx, 0, "data")          # global order
                 if dat is not None else flat_idx)
        oh = F.one_hot(every, e)                                # (T*k, E)
        pos_all = torch.cumsum(oh, dim=0) - oh
        pos = pos_all.gather(1, every[:, None])[:, 0]
        pos = pos[j * t * kk:(j + 1) * t * kk]
    keep = pos < cap
    dest = torch.where(keep, flat_idx * cap + pos, e * cap)     # OOB -> drop
    return {"probs": probs, "gate_vals": gate_vals, "gate_idx": gate_idx,
            "cap": cap, "keep": keep, "dest": dest}


MOE_SPECS = {"router": ("embed", None),
             "wi_gate": ("experts", "embed", "mlp"),
             "wi_up": ("experts", "embed", "mlp"),
             "wo": ("experts", "mlp", "embed")}


def moe(
    p: Params, x: torch.Tensor, cfg: ModelConfig,
    capacity_factor: float = 1.25, dispatch_hint: bool = True,
    sp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k routing with SCATTER/GATHER dispatch.

    Each (token, choice) is copied to its slot ``expert*cap + position`` of
    an (E*cap, d) expert buffer; overflowing choices go to one spare row
    past the end, which is dropped, and read back as zero.  The experts run
    as batched matmuls over (E, cap, d) and the results are gathered back
    with the same index map.  Returns (out, aux_loss).

    Inside ``activation_hints`` it runs on this rank's tokens (its rows of
    the batch, the whole sequence) with the one-device step's routing
    (``moe_route``).  Experts split over "model" (or, when they do not
    divide, the hidden dim does): each rank fills the slots of its experts
    from its tokens, the slots of all "data" ranks are summed (with
    ``dispatch_hint``, reduce-scattered so each rank runs its share of the
    capacity, ``moe_out_spec``), and the outputs are summed over "model" by
    ``region_out``.  The load-balancing loss is the global one; inside a
    region only "model" rank 0 takes its gradient, so it is counted once.
    On one device ``dispatch_hint`` changes nothing."""
    p = shard_lib.param_hints(p, MOE_SPECS)
    e, kk = cfg.num_experts, cfg.experts_per_token
    mod, dat = shard_lib.mesh_axis("model"), shard_lib.batch_axis("data")
    ed = shard_lib.model_dim(p["wi_gate"])
    split = ed is not None
    if mod is not None and not split:
        p = {k: shard_lib.whole(w, "slice") for k, w in p.items()}
    if split:
        p = dict(p, router=shard_lib.partial(p["router"]))
    x = shard_lib.region_in(x, split, sp)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    r = moe_route(p, xt, cfg, capacity_factor)
    cap, keep, dest = r["cap"], r["keep"], r["dest"]
    e_l = e
    if ed == 0:                         # this rank's experts only
        e_l = e // mod.size
        e0 = mod.rank * e_l
        flat_idx = r["gate_idx"].reshape(-1)
        keep = keep & (flat_idx >= e0) & (flat_idx < e0 + e_l)
        dest = torch.where(keep, dest - e0 * cap, e_l * cap)

    x_rep = xt.repeat_interleave(kk, dim=0)                     # (T*k, d)
    buf = torch.zeros((e_l * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, dest, x_rep)[: e_l * cap]
    xe = buf.reshape(e_l, cap, d)
    by_cap = (dispatch_hint and dat is not None
              and shard_lib.moe_out_spec(shard_lib.hint_mesh(),
                                         (e, cap, d))[1] == "data")
    if by_cap:
        xe = shard_lib.reduce_scatter(xe, 1, "data")
    elif dat is not None:
        xe = shard_lib.all_reduce(xe, "data", grad="sum")
    h = torch.bmm(xe, p["wi_gate"])
    h = F.silu(h) * torch.bmm(xe, p["wi_up"])
    ye = torch.bmm(h, p["wo"])
    if by_cap:
        ye = shard_lib.gather(ye, 1, "data")
    ye = ye.reshape(e_l * cap, d)
    y = ye[torch.clamp(dest, max=e_l * cap - 1)]                # (T*k, d)
    y = y.masked_fill(~keep[:, None], 0.0)
    out = (y.reshape(t, kk, d)
           * r["gate_vals"][..., None].to(y.dtype)).sum(1).reshape(b, s, d)
    # load-balancing aux loss (Switch-style), over every rank's tokens
    density = F.one_hot(r["gate_idx"], e).amax(1).float()
    if dat is None:
        density, p_mean = density.mean(0), r["probs"].mean(0)
    else:
        n = float(t * dat.size)
        density = shard_lib.all_reduce(density.sum(0), "data") / n
        p_mean = shard_lib.all_reduce(r["probs"].sum(0), "data") / n
    aux = (density * p_mean).sum() * (e ** 2) / kk
    if split and mod.rank != 0:
        aux = aux.detach()
    return shard_lib.region_out(out, split, sp), aux
