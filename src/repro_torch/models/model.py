"""Model zoo composer — port of ``src/repro/models/model.py``: builds any of
the ten architectures from its ``ModelConfig`` with a uniform interface:

    model = build_model(cfg, device="cuda", generator=g)
    loss, metrics = model.loss(batch)
    logits, cache = model.prefill(batch, max_len=...)
    logits, cache = model.decode_step(cache, tokens)

``Model`` is an ``nn.Module`` that owns its weights: each layer keeps its own
tensors (``blocks``, ``enc_blocks`` and ``cross_blocks`` are
``nn.ModuleList``s of ``ParamTree``s, whose parameter names are the
reference's pytree keys), where the reference stacks a leading layer axis
and scans it.  ``params_from_reference`` carries a reference pytree across.

Families: dense | moe | vlm (prefix-LM over stub patch embeddings) | ssm
(Mamba-1) | hybrid (Mamba-2 + shared attention, zamba2-style) | encdec
(audio frames -> encoder, tokens -> decoder with cross-attention).

The serving path is functional, as the reference's is: ``prefill``,
``prefill_chunked`` and ``decode_step`` return a new ``DecodeCache`` and
never write the caller's tensors, and run under ``torch.no_grad()``: they
build no autograd graph, whether or not the weights require gradients.
``DecodeCache.length`` is a host int (the reference keeps a device scalar):
positions and cache slots are computed on the host, with no device read a
step.

Sharded training (``train.loop``'s sharded step) runs ``loss`` inside
``distributed.sharding.activation_hints`` on each rank's local weight
shards, with the layers tensor-parallel (``models/layers.py``), the vocabulary split over "model" in the embedding
and the cross-entropy, and ``seq_parallel`` live.  Sharded serving
(``train.loop.make_serve_step`` / ``make_prefill_step``) runs ``prefill``,
``prefill_chunked`` and ``decode_step`` the same way on this rank's rows of
the batch: ``init_cache`` makes this rank's cache leaves, placed by
``sharding.cache_shardings`` and tagged with their specs, which every
layer keeps on the leaves it returns, and the logits are this rank's
vocabulary block where the vocabulary splits.

Training (``repro_torch.train``): ``loss`` is also the module's ``forward``,
so ``torch.func.functional_call(model, params, (batch,))`` takes the loss of
any state dict; with ``remat="block"`` each block runs under
``torch.utils.checkpoint`` whenever autograd records through it.
``params_to_reference`` re-stacks a state dict into the reference's
pytree.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (
    BLOCK_ATTN,
    BLOCK_MAMBA1,
    BLOCK_MAMBA2,
    BLOCK_SHARED_ATTN,
    ModelConfig,
)
from repro_torch.distributed import sharding as shard_lib
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


# ---------------------------------------------------------------------------
# Per-block init
# ---------------------------------------------------------------------------

def _init_block(generator: torch.Generator, cfg: ModelConfig, kind: str):
    """(weights, logical specs) of one block, as nested dicts."""
    def norm():
        return torch.zeros((cfg.d_model,), dtype=torch.float32,
                           device=generator.device)

    if kind == BLOCK_ATTN:
        attn_p, attn_s = L.init_attention(generator, cfg)
        if cfg.family == "moe":
            ff_p, ff_s = L.init_moe(generator, cfg)
        else:
            ff_p, ff_s = L.init_mlp(generator, cfg)
        p = {"ln1": norm(), "attn": attn_p, "ln2": norm(), "ff": ff_p}
        s = {"ln1": ("embed",), "attn": attn_s, "ln2": ("embed",), "ff": ff_s}
    elif kind == BLOCK_MAMBA1:
        m_p, m_s = S.init_mamba(generator, cfg)
        p = {"ln1": norm(), "ssm": m_p}
        s = {"ln1": ("embed",), "ssm": m_s}
    elif kind == BLOCK_MAMBA2:
        # zamba2 geometry: the mamba2 blocks carry no MLP — the MLP lives in
        # the (single, shared) attention block
        m_p, m_s = S.init_mamba2(generator, cfg)
        p = {"ln1": norm(), "ssm": m_p}
        s = {"ln1": ("embed",), "ssm": m_s}
    else:
        raise ValueError(kind)
    return p, s


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: tensors become parameters under
    their keys, dicts become sub-trees.  ``tree()`` hands the dict back for
    the functional layers.  Parameters are created with ``requires_grad``
    off; ``train.loop.init_train_state`` turns it on."""

    def __init__(self, tree: Dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def tree(self) -> Dict:
        out = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


def _flat_specs(prefix: str, specs: Dict, out: Dict) -> Dict:
    for k, v in specs.items():
        if isinstance(v, dict):
            _flat_specs(f"{prefix}{k}.", v, out)
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# Cache containers
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Stacked per-layer caches + the fill pointer (a host int)."""
    kv_k: Optional[torch.Tensor]       # (n_attn, B, cap, Hkv, hd)
    kv_v: Optional[torch.Tensor]
    conv: Optional[torch.Tensor]       # (n_ssm, B, conv-1, width)
    ssm: Optional[torch.Tensor]        # (n_ssm, B, di(, ...), ds)
    enc_out: Optional[torch.Tensor]    # (B, S_enc, d) — encdec only
    length: int

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self[:5]
                   if t is not None)


class _Shape(NamedTuple):
    """A leaf's shape, for ``cache_shardings`` (which reads ``shape`` and
    ``ndim``), with no tensor behind it."""
    shape: Tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _cache_capacity(cfg: ModelConfig, max_len: int, ring_mult: int = 1) -> int:
    if cfg.sliding_window > 0:
        return min(max_len, ring_mult * cfg.sliding_window)
    return max_len


def _stack(ts, like=None):
    """The layers' caches stacked, with the placement (``shard_lib.tag``)
    of ``like``, the stacked leaf they came from."""
    if not ts:
        return None
    out = torch.stack(ts)
    spec = getattr(like, "_shard_spec", None)
    return out if spec is None else shard_lib.tag(out, spec)


def _layer(t: torch.Tensor, i: int) -> torch.Tensor:
    """Layer ``i`` of a stacked cache leaf, with the leaf's placement less
    its layer dim."""
    spec = getattr(t, "_shard_spec", None)
    return t[i] if spec is None else shard_lib.tag(t[i], spec[1:])


# ---------------------------------------------------------------------------
# The Model object
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """One architecture with its weights.  The fields are the reference's:

    * ``remat`` — "block" runs each block (attention, mamba, the
      encoder's; not the hybrid's shared block, which the reference runs
      outside its remat scans) under ``torch.utils.checkpoint`` when
      autograd records through it, so its activations are recomputed in the
      backward: the reference's ``jax.checkpoint`` with
      ``nothing_saveable``.  The gradients are bit-equal to "none"'s.
    * ``q_chunk`` — attention runs over query blocks of this many rows when
      the sequence is a multiple of it.
    * ``ssm_chunk`` — the selective scan's chunk.
    * ``moe_capacity`` — the MoE capacity factor.
    * ``moe_dispatch_hint`` — inside ``activation_hints``, the expert
      buffer's capacity slots split over "data" (``models.layers.moe``).
    * ``seq_parallel`` — inside ``activation_hints``, the residual stream's
      sequence split over "model" between the tensor-parallel layers
      (``seq_parallel_spec``), when "model" divides it.
    Both change nothing on one device.
    """

    def __init__(self, config: ModelConfig, remat: str = "block",
                 q_chunk: int = 1024, ssm_chunk: int = 256,
                 moe_capacity: float = 1.25, moe_dispatch_hint: bool = True,
                 seq_parallel: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.remat = remat
        self.q_chunk = q_chunk
        self.ssm_chunk = ssm_chunk
        self.moe_capacity = moe_capacity
        self.moe_dispatch_hint = moe_dispatch_hint
        self.seq_parallel = seq_parallel
        self.device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.specs = self.init(generator)[1]

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator):
        """Draws every weight from ``generator`` (on the model's device) with
        the reference's shapes, scales and dtypes and registers it.  Returns
        (state dict, logical-axis specs keyed by the same names)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.config
        g = generator
        dt = L.torch_dtype(cfg.dtype)
        d = cfg.d_model
        specs: Dict = {"embed": ("vocab", "embed"), "ln_f": ("embed",)}
        self.embed = nn.Parameter(L.normal(g, (cfg.vocab_size, d), 0.02, dt),
                                  requires_grad=False)
        self.ln_f = nn.Parameter(torch.zeros((d,), dtype=torch.float32,
                                             device=self.device),
                                 requires_grad=False)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                L.normal(g, (d, cfg.vocab_size), d**-0.5, dt),
                requires_grad=False)
            specs["unembed"] = ("embed", "vocab")

        def stack(kind, n, name):
            trees = []
            for i in range(n):
                p, s = _init_block(g, cfg, kind)
                trees.append(ParamTree(p))
                _flat_specs(f"{name}.{i}.", s, specs)
            setattr(self, name, nn.ModuleList(trees))

        pattern = cfg.block_pattern()
        if cfg.family in ("dense", "moe", "vlm"):
            stack(BLOCK_ATTN, cfg.num_layers, "blocks")
        elif cfg.family == "ssm":
            stack(BLOCK_MAMBA1, cfg.num_layers, "blocks")
        elif cfg.family == "hybrid":
            stack(BLOCK_MAMBA2, sum(1 for b in pattern if b == BLOCK_MAMBA2),
                  "blocks")
            # the single SHARED attention block (weights tied across uses)
            sp, ss = _init_block(g, cfg, BLOCK_ATTN)
            self.shared_attn = ParamTree(sp)
            _flat_specs("shared_attn.", ss, specs)
        elif cfg.family == "encdec":
            stack(BLOCK_ATTN, cfg.num_layers, "blocks")
            stack(BLOCK_ATTN, cfg.encoder_layers, "enc_blocks")
            # cross-attention re-uses attention geometry (q from decoder,
            # kv from encoder output)
            cross = []
            for i in range(cfg.num_layers):
                ap, as_ = L.init_attention(g, cfg)
                cross.append(ParamTree({
                    "ln": torch.zeros((d,), dtype=torch.float32,
                                      device=self.device), "attn": ap}))
                _flat_specs(f"cross_blocks.{i}.",
                            {"ln": ("embed",), "attn": as_}, specs)
            self.cross_blocks = nn.ModuleList(cross)
        else:
            raise ValueError(cfg.family)

        if cfg.frontend_dim:
            self.frontend_proj = nn.Parameter(
                L.normal(g, (cfg.frontend_dim, d), cfg.frontend_dim**-0.5, dt),
                requires_grad=False)
            specs["frontend_proj"] = (None, "embed")
        return self.state_dict(), specs

    # ------------------------------------------------------------- forwards
    def _norm(self, x, w, sp=False):
        """RMSNorm by a norm weight of the residual stream (FSDP-gathered
        inside ``activation_hints``; a partial sum under ``sp``)."""
        w = shard_lib.seq_partial(shard_lib.param_hint(w, ("embed",)), sp)
        return L.rms_norm(x, w, self.config.norm_eps)

    def _attn_block(self, bp, x, positions, kv=None, cache_len=None,
                    prefix_len=0, attend_cache=False, sp=False):
        cfg = self.config
        h, new_kv = L.attention(
            bp["attn"], self._norm(x, bp["ln1"], sp), cfg,
            positions, kv_cache=kv, cache_len=cache_len,
            q_chunk=self.q_chunk, prefix_len=prefix_len,
            attend_cache=attend_cache, sp=sp,
        )
        x = x + h
        y = self._norm(x, bp["ln2"], sp)
        if cfg.family == "moe":
            ff, aux = L.moe(bp["ff"], y, cfg, self.moe_capacity,
                            dispatch_hint=self.moe_dispatch_hint, sp=sp)
        else:
            ff, aux = L.mlp(bp["ff"], y, sp=sp), 0.0
        return x + ff, new_kv, aux

    def _mamba_block(self, bp, x, state=None, kind=BLOCK_MAMBA1, sp=False):
        cfg = self.config
        fn = S.mamba if kind == BLOCK_MAMBA1 else S.mamba2
        h, new_state = fn(
            bp["ssm"], self._norm(x, bp["ln1"], sp), cfg,
            state=state, chunk=self.ssm_chunk, sp=sp,
        )
        return x + h, new_state

    def _cross_block(self, cp, x, enc_out, enc_positions, sp=False,
                     enc_sp=False):
        """Decoder cross-attention: q from x, kv from encoder output (no
        RoPE, no mask, no softcap); tensor-parallel as ``L.attention``."""
        cfg = self.config
        hd = cfg.resolved_head_dim
        y = self._norm(x, cp["ln"], sp)
        hp = L.head_plan(shard_lib.param_hints(cp["attn"], L.ATTN_SPECS),
                         cfg)
        a, nq, nkv = hp.w, hp.nq, hp.nkv
        y = shard_lib.region_in(y, hp.split, sp)
        enc_out = shard_lib.region_in(enc_out, hp.split, enc_sp)
        b, s, d = y.shape
        q = (y @ a["wq"]).reshape(b, s, nq, hd)
        k = (enc_out @ a["wk"]).reshape(b, -1, nkv, hd)
        v = (enc_out @ a["wv"]).reshape(b, -1, nkv, hd)
        if hp.kv_sel is not None:
            k, v = k.narrow(2, *hp.kv_sel), v.narrow(2, *hp.kv_sel)
            nkv = hp.kv_sel[1]
        g = nq // nkv
        qg = q.reshape(b, s, nkv, g, hd)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                              k.float()) * hd**-0.5
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
        return x + shard_lib.row_out(o.reshape(b, s, nq * hd), a["wo"],
                                     hp.split, sp)

    def _remat(self, fn, x):
        """``fn(x)``; under ``torch.utils.checkpoint`` when ``remat`` is
        "block" and autograd records through the block's input (the
        reference's ``_maybe_remat``).  ``fn`` closes over the block's
        weights, taken from the module when the forward runs, so a recompute
        in the backward reads the tensors the forward read (also under
        ``functional_call``)."""
        if (self.remat == "block" and torch.is_grad_enabled()
                and x.requires_grad):
            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)

    def _decoder_stack(self, x, positions, caches=None, cache_len=None,
                       prefix_len=0, enc_out=None, enc_positions=None,
                       attend_cache=False, sp=False, enc_sp=False):
        """Runs the decoder stack, layer by layer. Returns (x, new_caches,
        aux).  ``sp`` / ``enc_sp``: ``x`` / ``enc_out`` are
        sequence-parallel (``positions`` cover the whole sequence)."""
        cfg = self.config
        fam = cfg.family

        if fam in ("dense", "moe", "vlm", "encdec"):
            new_k, new_v, aux = [], [], 0.0
            for i, blk in enumerate(self.blocks):
                kv = None if caches is None else (_layer(caches.kv_k, i),
                                                  _layer(caches.kv_v, i))
                cp = (self.cross_blocks[i].tree() if fam == "encdec"
                      else None)

                def block(x, bp=blk.tree(), cp=cp, kv=kv):
                    x, new_kv, a = self._attn_block(
                        bp, x, positions, kv, cache_len, prefix_len,
                        attend_cache=attend_cache, sp=sp)
                    if cp is not None:
                        x = self._cross_block(cp, x, enc_out, enc_positions,
                                              sp=sp, enc_sp=enc_sp)
                    return x, new_kv, a

                x, new_kv, a = self._remat(block, x)
                aux = aux + a
                if new_kv is not None:
                    new_k.append(new_kv[0])
                    new_v.append(new_kv[1])
            new_caches = None
            if caches is not None:
                new_caches = caches._replace(
                    kv_k=_stack(new_k, caches.kv_k),
                    kv_v=_stack(new_v, caches.kv_v))
            return x, new_caches, aux

        if fam == "ssm":
            new_conv, new_ssm = [], []
            for i, blk in enumerate(self.blocks):
                st = None if caches is None else (_layer(caches.conv, i),
                                                  _layer(caches.ssm, i))

                def block(x, bp=blk.tree(), st=st):
                    return self._mamba_block(bp, x, st, BLOCK_MAMBA1, sp=sp)

                x, (cv, ss) = self._remat(block, x)
                new_conv.append(cv)
                new_ssm.append(ss)
            new_caches = None
            if caches is not None:
                new_caches = caches._replace(
                    conv=_stack(new_conv, caches.conv),
                    ssm=_stack(new_ssm, caches.ssm))
            return x, new_caches, 0.0

        if fam == "hybrid":
            return self._hybrid_stack(x, positions, caches, cache_len,
                                      attend_cache=attend_cache, sp=sp)

        raise ValueError(fam)

    def _hybrid_stack(self, x, positions, caches, cache_len,
                      attend_cache=False, sp=False):
        """zamba2: mamba2 blocks with a SHARED attention block every
        ``attn_every`` layers. The shared block's weights are reused at every
        occurrence; its KV caches are per-occurrence."""
        cfg = self.config
        pattern = cfg.block_pattern()
        n_groups = sum(1 for b in pattern if b == BLOCK_SHARED_ATTN)
        m_per_group = (cfg.attn_every or 6) - 1
        n_m = len(self.blocks)
        shared = self.shared_attn.tree()
        new_conv, new_ssm, new_k, new_v = [], [], [], []

        def mamba_run(x, start, count):
            for i in range(start, start + count):
                st = None if caches is None else (_layer(caches.conv, i),
                                                  _layer(caches.ssm, i))

                def block(x, bp=self.blocks[i].tree(), st=st):
                    return self._mamba_block(bp, x, st, BLOCK_MAMBA2, sp=sp)

                x, (cv, ss) = self._remat(block, x)
                new_conv.append(cv)
                new_ssm.append(ss)
            return x

        mi = 0
        for gi in range(n_groups):
            x = mamba_run(x, mi, m_per_group)
            mi += m_per_group
            kv = None if caches is None else (_layer(caches.kv_k, gi),
                                              _layer(caches.kv_v, gi))

            # the reference scans the mamba blocks under remat and runs the
            # shared block as it is
            x, new_kv, _ = self._attn_block(shared, x, positions, kv,
                                            cache_len,
                                            attend_cache=attend_cache, sp=sp)
            if new_kv is not None:
                new_k.append(new_kv[0])
                new_v.append(new_kv[1])
        x = mamba_run(x, mi, n_m - mi)                   # the tail
        new_caches = None
        if caches is not None:
            new_caches = caches._replace(
                conv=_stack(new_conv, caches.conv),
                ssm=_stack(new_ssm, caches.ssm),
                kv_k=_stack(new_k, caches.kv_k),
                kv_v=_stack(new_v, caches.kv_v))
        return x, new_caches, 0.0

    def _positions(self, b: int, s: int, start: int = 0) -> torch.Tensor:
        return torch.arange(start, start + s,
                            device=self.device)[None].expand(b, s)

    def _encode(self, frames, sp=False):
        """Encoder stack over frontend frame embeddings (bidirectional)."""
        cfg = self.config
        frames = torch.as_tensor(frames, device=self.device)
        proj = shard_lib.param_hint(self.frontend_proj, (None, "embed"))
        x = frames.to(L.torch_dtype(cfg.dtype)) @ proj
        b, s, _ = x.shape
        positions = self._positions(b, s)
        x = self._residual_hint(x, sp)
        for blk in self.enc_blocks:
            def block(x, bp=blk.tree()):
                return self._attn_block(bp, x, positions, prefix_len=s,
                                        sp=sp)[0]

            x = self._remat(block, x)
        return x, positions

    def _embed_tokens(self, tokens) -> torch.Tensor:
        """The embeddings of ``tokens``.  Inside ``activation_hints`` a
        vocabulary split over "model" is looked up where it lies, masked,
        and summed over "model"."""
        tokens = torch.as_tensor(tokens, device=self.device)
        emb = shard_lib.param_hint(self.embed, ("vocab", "embed"))
        if shard_lib.model_dim(emb) != 0:
            return emb[tokens]
        v_l = emb.shape[0]
        v0 = shard_lib.mesh_axis("model").rank * v_l
        here = (tokens >= v0) & (tokens < v0 + v_l)
        x = emb[(tokens - v0).clamp(0, v_l - 1)]
        return shard_lib.all_reduce(
            torch.where(here[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device)))

    def _embed_inputs(self, batch):
        """tokens (+ frontend embeddings) -> (x, positions, prefix_len)."""
        cfg = self.config
        x = self._embed_tokens(batch["tokens"])
        if cfg.family == "vlm":
            front = torch.as_tensor(batch["frontend"], device=self.device)
            proj = shard_lib.param_hint(self.frontend_proj, (None, "embed"))
            pre = front.to(x.dtype) @ proj
            x = torch.cat([pre, x], dim=1)
            prefix = cfg.frontend_tokens
        else:
            prefix = 0
        b, s, _ = x.shape
        return x, self._positions(b, s), prefix

    def _unembed(self):
        """(the unembedding as the logits use it, (d, V) — this rank's
        vocabulary block inside ``activation_hints`` when the vocabulary
        splits over "model" —, whether it splits)."""
        if self.config.tie_embeddings:
            w = shard_lib.param_hint(self.embed, ("vocab", "embed"))
            return w.T, shard_lib.model_dim(w) == 0
        w = shard_lib.param_hint(self.unembed, ("embed", "vocab"))
        return w, shard_lib.model_dim(w) == 1

    def _logits(self, x):
        return self._head(x)[0]

    def _head(self, x, sp=False):
        """(the logits — this rank's vocabulary block when it splits —,
        whether it splits)."""
        cfg = self.config
        x = self._norm(x, self.ln_f, sp)
        w, split = self._unembed()
        logits = shard_lib.region_in(x, split, sp) @ w
        if cfg.logit_softcap > 0:
            c = cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return logits, split

    def _residual_hint(self, x, sp):
        """The residual stream into its sequence-parallel layout when
        ``sp`` (``seq_parallel_spec``)."""
        return shard_lib.hint(x, shard_lib.seq_parallel_spec) if sp else x

    def _sp(self, seq: int) -> bool:
        """Whether the residual stream of a ``seq``-long sequence is
        sequence-parallel: ``seq_parallel`` set, inside
        ``activation_hints`` with a "model" axis that divides ``seq``."""
        ax = shard_lib.mesh_axis("model")
        return bool(self.seq_parallel and ax is not None
                    and seq % ax.size == 0)

    # ------------------------------------------------------------ the loss
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss: mean next-token NLL over labels >= 0, plus
        0.01 x the MoE aux loss.  Autograd records it when gradients are
        on and the weights require them (``train.loop``).

        Inside ``activation_hints`` it runs on this rank's rows of the
        batch and its shards of the weights: the residual stream
        sequence-parallel when ``seq_parallel``, the logits this rank's
        vocabulary block when it splits, the cross-entropy over the split
        vocabulary (f32 logits, the max and the sum of exponentials and the
        label's logit summed over "model"), and the mean over every rank's
        labels >= 0 (sums over the batch axes).  The value is the global
        loss on every rank; the gradients are this rank's share, which the
        collectives' backwards add up.  Outside it every collective is the
        identity."""
        cfg = self.config
        enc_out = enc_pos = None
        enc_sp = False
        if cfg.family == "encdec":
            frames = torch.as_tensor(batch["frontend"], device=self.device)
            enc_sp = self._sp(frames.shape[1])
            enc_out, enc_pos = self._encode(frames, sp=enc_sp)
        x, positions, prefix = self._embed_inputs(batch)
        sp = self._sp(x.shape[1])
        x = self._residual_hint(x, sp)
        x, _, aux = self._decoder_stack(
            x, positions, prefix_len=prefix, enc_out=enc_out,
            enc_positions=enc_pos, sp=sp, enc_sp=enc_sp)
        logits, split = self._head(x, sp)
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        if prefix:
            logits = logits[:, prefix:, :]
        lg = logits.float()
        if split:
            v_l = lg.shape[-1]
            v0 = shard_lib.mesh_axis("model").rank * v_l
            mx = shard_lib.all_reduce_max(lg.amax(-1, keepdim=True))
            lse = torch.log(shard_lib.all_reduce(
                torch.exp(lg - mx).sum(-1))) + mx[..., 0]
            here = (labels >= v0) & (labels < v0 + v_l)
            ll = lg.gather(-1, (labels - v0).clamp(0, v_l - 1)[..., None])
            ll = shard_lib.all_reduce(ll[..., 0] * here)
        else:
            lse = torch.logsumexp(lg, dim=-1)
            ll = lg.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        num, den = ((lse - ll) * mask).sum(), mask.sum()
        mesh = shard_lib.hint_mesh()
        for a in shard_lib.batch_axes(mesh) if mesh is not None else ():
            num, den = (shard_lib.all_reduce(num, a),
                        shard_lib.all_reduce(den, a))
        nll = num / torch.clamp(den, min=1.0)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=self.device)
        total = nll + 0.01 * aux
        return total, {"nll": nll, "aux": aux}

    _METHODS = ("loss", "prefill", "prefill_chunked", "decode_step")

    def forward(self, *args, method: str = "loss", **kw):
        """``loss`` (or the serving ``method`` named): what
        ``torch.func.functional_call`` runs."""
        if method not in self._METHODS:
            raise ValueError(f"forward runs one of {self._METHODS}, not "
                             f"{method!r}")
        return getattr(self, method)(*args, **kw)

    # -------------------------------------------------------------- serving
    def init_cache(self, batch_size: int, max_len: int,
                   ring_mult: int = 1) -> DecodeCache:
        """A zero cache for ``batch_size`` sequences of up to ``max_len``
        positions.  Inside ``activation_hints`` ``batch_size`` is the
        global batch and the leaves are this rank's shards, placed by
        ``cache_shardings`` over the hint mesh and tagged with their
        specs."""
        cfg = self.config
        dt = L.torch_dtype(cfg.dtype)
        hd = cfg.resolved_head_dim
        cap = _cache_capacity(cfg, max_len, ring_mult)
        pattern = cfg.block_pattern()
        n_attn = sum(1 for b in pattern
                     if b in (BLOCK_ATTN, BLOCK_SHARED_ATTN))
        n_ssm = len(pattern) - n_attn
        shapes = {}
        if n_attn:
            kv = ((n_attn, batch_size, cap, cfg.num_kv_heads, hd), dt)
            shapes.update(kv_k=kv, kv_v=kv)
        di = cfg.ssm_expand * cfg.d_model
        if cfg.family == "ssm":
            shapes.update(
                conv=((n_ssm, batch_size, cfg.ssm_conv - 1, di), dt),
                ssm=((n_ssm, batch_size, di, cfg.ssm_state), torch.float32))
        elif cfg.family == "hybrid":
            hd2 = S.MAMBA2_HEAD_DIM
            shapes.update(
                conv=((n_ssm, batch_size, cfg.ssm_conv - 1,
                       di + 2 * cfg.ssm_state), dt),
                ssm=((n_ssm, batch_size, di // hd2, hd2, cfg.ssm_state),
                     torch.float32))
        empty = DecodeCache(None, None, None, None, None, 0)
        mesh = shard_lib.hint_mesh()
        if mesh is None:
            return empty._replace(**{
                f: torch.zeros(shp, dtype=t, device=self.device)
                for f, (shp, t) in shapes.items()})
        specs = shard_lib.cache_shardings(mesh, empty._replace(**{
            f: _Shape(shp) for f, (shp, _) in shapes.items()}), cfg)
        out = {}
        for f, (shp, t) in shapes.items():
            spec = getattr(specs, f).spec
            out[f] = shard_lib.tag(torch.zeros(
                shard_lib.local_shape(shp, spec, mesh), dtype=t,
                device=self.device), spec)
        return empty._replace(**out)

    @torch.no_grad()
    def prefill(self, batch, max_len: Optional[int] = None):
        """Single-shot prefill: (logits of the last position (B, 1, V), a
        cache holding the prompt, room for ``max_len`` positions)."""
        cfg = self.config
        b, s = batch["tokens"].shape
        internal = s + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
        cache = self.init_cache(shard_lib.global_batch(b),
                                max(max_len or 0, internal + 1))
        if cfg.family == "encdec":
            enc_out, enc_pos = self._encode(batch["frontend"])
            if shard_lib.hint_mesh() is not None:
                enc_out = shard_lib.tag(enc_out, (shard_lib.batch_entry(),
                                                  None, None))
            cache = cache._replace(enc_out=enc_out)
            x, positions, prefix = self._embed_inputs(batch)
            x, cache, _ = self._decoder_stack(
                x, positions, caches=cache, cache_len=0,
                enc_out=enc_out, enc_positions=enc_pos)
        else:
            x, positions, prefix = self._embed_inputs(batch)
            x, cache, _ = self._decoder_stack(
                x, positions, caches=cache, cache_len=0, prefix_len=prefix)
        cache = cache._replace(length=x.shape[1])
        return self._logits(x[:, -1:, :]), cache

    @torch.no_grad()
    def prefill_chunked(self, batch, seg_len: int = 4096,
                        max_len: Optional[int] = None):
        """Segmented prefill: the prompt is processed ``seg_len`` tokens at
        a time against the growing KV cache, bounding attention logits and
        MoE dispatch buffers to one segment.  SWA archs use a 2x-window ring
        so every query's window is resident.  Not supported for vlm (prefix
        handling) or encdec (cross-attn) — those use the single-shot path."""
        cfg = self.config
        if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise ValueError(f"prefill_chunked does not serve {cfg.family}")
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        b, s = tokens.shape
        if s % seg_len:
            raise ValueError(f"prompt length {s} is not a multiple of "
                             f"seg_len {seg_len}")
        if cfg.sliding_window > 0 and seg_len > cfg.sliding_window:
            raise ValueError("segment must fit the window")
        # SWA: a 2x-window ring keeps every in-segment query's window
        # resident; others: full cache
        cache = self.init_cache(shard_lib.global_batch(b),
                                max(max_len or 0, s + 1), ring_mult=2)
        for s0 in range(0, s, seg_len):
            x = self._embed_tokens(tokens[:, s0 : s0 + seg_len])
            positions = self._positions(b, seg_len, cache.length)
            x, cache2, _ = self._decoder_stack(
                x, positions, caches=cache, cache_len=cache.length,
                attend_cache=True)
            cache = cache2._replace(length=cache.length + seg_len)
        return self._logits(x[:, -1:, :]), cache

    @torch.no_grad()
    def decode_step(self, cache: DecodeCache, tokens):
        """tokens: (B, 1) — one decode step against the cache.  Returns
        (logits (B, 1, V), a new cache); ``cache`` is left as it was."""
        cfg = self.config
        x = self._embed_tokens(tokens)
        b, s, _ = x.shape
        positions = self._positions(b, s, cache.length)
        if cfg.family == "encdec":
            enc_pos = self._positions(b, cache.enc_out.shape[1])
            x, cache2, _ = self._decoder_stack(
                x, positions, caches=cache, cache_len=cache.length,
                enc_out=cache.enc_out, enc_positions=enc_pos)
        else:
            x, cache2, _ = self._decoder_stack(
                x, positions, caches=cache, cache_len=cache.length)
        cache2 = cache2._replace(length=cache.length + s,
                                 enc_out=cache.enc_out)
        return self._logits(x), cache2


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None, **kw) -> Model:
    """The model of ``cfg`` on ``device`` (the card unless told otherwise),
    its weights drawn from ``generator`` (seed 0 when None)."""
    return Model(cfg, device=device, generator=generator, **kw)


# ---------------------------------------------------------------------------
# Weights carried across from the reference
# ---------------------------------------------------------------------------

_LAYERED = ("blocks", "enc_blocks", "cross_blocks")


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # numpy has no bf16: via f32, exact
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable copy


def params_from_reference(cfg: ModelConfig, params: Dict) -> Dict:
    """A state dict for ``Model.load_state_dict`` from the reference's
    ``model.init`` pytree (numpy arrays, nested dicts): the stacked layer
    axis of ``blocks``, ``enc_blocks`` and ``cross_blocks`` is unstacked
    into one entry per layer; ``shared_attn``, ``frontend_proj``, ``embed``,
    ``unembed`` and ``ln_f`` keep their names.  ``cfg`` is the model's
    config; ``load_state_dict`` (strict) checks every name and shape."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix, node, layer=None):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v, layer)
            elif layer is None:
                out[f"{prefix}{k}"] = _tensor(v)
            else:
                for i in range(np.shape(v)[0]):
                    out[f"{layer}.{i}.{prefix}{k}"] = _tensor(np.asarray(v)[i])

    for k, v in params.items():
        if k in _LAYERED:
            walk("", v, layer=k)
        elif isinstance(v, dict):
            walk(f"{k}.", v)
        else:
            out[k] = _tensor(v)
    return out


# ---------------------------------------------------------------------------
# ... and back: the reference's stacked pytree
# ---------------------------------------------------------------------------

def reference_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """(the reference's pytree path, the layer) of a state-dict name:
    ``blocks.3.attn.wq`` -> (("blocks", "attn", "wq"), 3), ``embed`` ->
    (("embed",), None)."""
    parts = name.split(".")
    if parts[0] in _LAYERED and len(parts) > 2 and parts[1].isdigit():
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def stack_layers(params: Dict[str, torch.Tensor]) -> Dict:
    """The reference's pytree of a state dict (nested dicts; the layers of
    ``blocks``, ``enc_blocks`` and ``cross_blocks`` stacked on a leading
    axis), as detached tensors on the parameters' device, dtypes kept."""
    groups: Dict[Tuple[str, ...], Dict[Optional[int], torch.Tensor]] = {}
    for name, t in params.items():
        path, layer = reference_path(name)
        groups.setdefault(path, {})[layer] = t.detach()
    out: Dict = {}
    for path, layers in groups.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (layers[None] if None in layers else
                          torch.stack([layers[i] for i in range(len(layers))]))
    return out


def params_to_reference(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of ``params_from_reference``: the reference's pytree of a
    state dict (``stack_layers``) as numpy arrays on the host.  numpy has no
    bfloat16, so a bf16 leaf comes back as its exact f32 values."""
    def leaf(t):
        t = t.cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(v)
                for k, v in node.items()}

    return walk(stack_layers(params))


# ---------------------------------------------------------------------------
# Input specs (dry-run stand-ins)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape) -> Dict[str, torch.Tensor]:
    """The model's inputs for a shape cell (``configs.SHAPES``) as tensors
    on the ``meta`` device, with the reference's shapes and dtypes:
    ``train`` / ``prefill`` feed whole sequences; ``decode`` feeds one
    token against a cache of ``seq_len`` (built by the caller)."""
    b, s = shape.global_batch, shape.seq_len

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    i32, f32 = torch.int32, torch.float32
    batch: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        batch["tokens"] = sd((b, s), i32)
        if shape.kind == "train":
            batch["labels"] = sd((b, s), i32)
        if cfg.family == "vlm":
            batch["frontend"] = sd((b, cfg.frontend_tokens,
                                    cfg.frontend_dim), f32)
        if cfg.family == "encdec":
            batch["frontend"] = sd((b, s, cfg.frontend_dim), f32)
    else:  # decode: one new token, cache of seq_len supplied separately
        batch["tokens"] = sd((b, 1), i32)
    return batch
