"""Configuration dataclasses — the port's copy of ``src/repro/configs/base.py``.

Two families, as in the reference:

* ``ModelConfig`` (lines 24-160 of the reference) — an LM-family
  architecture (dense / MoE / VLM / hybrid / enc-dec / SSM) for the model zoo
  (``repro_torch.models``), with ``ShapeConfig`` and ``SHAPES``, the four
  input-shape cells.  ``param_count`` is the reference's analytic count,
  kept exactly: it leaves out ``ln_f``, ``frontend_proj`` and the SSM
  vectors, so it is not the sum of a model's tensor sizes.
* ``PQConfig`` through ``ProximaConfig`` and ``upgrade_config`` (lines
  185-402) — the paper's ANN-search configuration.

Field names and defaults are identical to the reference's, so a reference
config converts field for field.

``SearchConfig.use_pallas`` does not pick the kernels.  The port routes by
the device of its tensors instead: tensors on a CUDA device launch the
hand-written kernels of ``repro_torch.kernels``, tensors on the CPU take
their plain PyTorch versions (the reference's ``use_pallas=False`` path).
It does one thing, as in the reference: a tiled search with ``use_vmap``
None runs the batched fan-out when ``use_pallas`` is False and the unrolled
one (each tile's rounds launched on their own) when it is True.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

BLOCK_ATTN = "attn"          # self-attention block
BLOCK_MAMBA1 = "mamba1"      # Mamba-1 selective SSM block
BLOCK_MAMBA2 = "mamba2"      # Mamba-2 SSD block
BLOCK_SHARED_ATTN = "shared_attn"  # zamba2-style shared (tied) attention block


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. ``family`` selects the forward pass."""

    name: str
    family: str                       # dense | moe | vlm | hybrid | encdec | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int                 # GQA; 0 for attention-free archs
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # MoE ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    # SSM ------------------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # Attention flavour -----------------------------------------------------
    sliding_window: int = 0           # 0 -> full attention
    rope_theta: float = 10000.0
    max_position: int = 131072
    # Hybrid (zamba2-style) --------------------------------------------------
    attn_every: int = 0               # insert shared attn block every k blocks
    # Enc-dec ----------------------------------------------------------------
    encoder_layers: int = 0           # >0 -> enc-dec; num_layers == decoder layers
    # VLM / audio frontend stub ----------------------------------------------
    frontend_tokens: int = 0          # patch/frame embeddings prepended (stub)
    frontend_dim: int = 0             # dim of the precomputed embeddings
    mlp_variant: str = "swiglu"       # swiglu (3 mats) | gelu (2 mats)
    # Numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # ----------------------------------------------------------------- utils
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode with a bounded state at 500k context?"""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window > 0
        )

    def block_pattern(self) -> Tuple[str, ...]:
        """Per-layer block types for the *decoder* stack."""
        if self.family == "ssm":
            return tuple(BLOCK_MAMBA1 for _ in range(self.num_layers))
        if self.family == "hybrid":
            pat = []
            every = self.attn_every or 6
            for i in range(self.num_layers):
                pat.append(BLOCK_SHARED_ATTN if (i % every == every - 1) else BLOCK_MAMBA2)
            return tuple(pat)
        return tuple(BLOCK_ATTN for _ in range(self.num_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), as the
        reference computes it for its roofline's MODEL_FLOPS."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        emb = v * d
        head = 0 if self.tie_embeddings else v * d
        per_attn = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
        mats = 3 if self.mlp_variant == "swiglu" else 2
        per_mlp = mats * d * dff
        if self.family == "moe":
            per_mlp = self.num_experts * mats * d * self.d_ff + d * self.num_experts
        # mamba1 block params: in_proj (d -> 2*e*d), conv, x_proj, dt_proj, out_proj
        e = self.ssm_expand
        di = e * d
        per_m1 = d * 2 * di + di * self.ssm_conv + di * (2 * self.ssm_state + di // 16 + 1) + di * d
        per_m2 = d * (2 * di + 2 * self.ssm_state + di // 64) + (
            di + 2 * self.ssm_state
        ) * self.ssm_conv + di * d
        norms = 2 * d
        total = emb + head
        for blk in self.block_pattern():
            if blk == BLOCK_ATTN:
                total += per_attn + per_mlp + norms
            elif blk == BLOCK_SHARED_ATTN:
                total += norms  # attn+mlp weights shared (counted once below)
            elif blk == BLOCK_MAMBA1:
                total += per_m1 + norms
            elif blk == BLOCK_MAMBA2:
                total += per_m2 + norms
        if self.family == "hybrid":
            total += per_attn + per_mlp  # the single shared block's weights
        if self.encoder_layers:
            # encoder self-attn + mlp, and decoder cross-attn addition
            total += self.encoder_layers * (per_attn + per_mlp + norms)
            total += self.num_layers * per_attn  # cross-attention per decoder layer
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense_like = dataclasses.replace(
            self, family="dense", num_experts=0, experts_per_token=0
        )
        base = dense_like.param_count() - self.num_layers * 3 * d * self.d_ff
        return int(
            base
            + self.num_layers
            * (self.experts_per_token * 3 * d * self.d_ff + d * self.num_experts)
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ModelConfig":
        return ModelConfig(**json.loads(s))


# ---------------------------------------------------------------------------
# Input shapes (the four shape cells)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Proxima (paper) configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PQConfig:
    """Product quantization geometry (paper: M=32 subvectors, C=256)."""
    num_subvectors: int = 32          # M
    num_centroids: int = 256          # C
    kmeans_iters: int = 10
    seed: int = 0


@dataclass(frozen=True)
class GraphConfig:
    """Vamana/DiskANN-style proximity-graph build (paper §V-A: R=64)."""
    max_degree: int = 64              # R
    build_list_size: int = 128        # L during build
    alpha: float = 1.2                # RRND pruning slack
    seed: int = 0


@dataclass(frozen=True)
class SearchConfig:
    """Algorithm 1 parameters."""
    k: int = 10
    list_size: int = 128              # L (outer list)
    t_init: int = 16                  # initial T
    t_step: int = 4                   # T_step
    repetition_rate: int = 2          # r — stable rounds before termination
    beta: float = 1.06                # PQ error ratio for reranking
    max_rounds: int = 256             # hard cap on traversal rounds
    beam_width: int = 1               # E — candidates expanded per round; the
                                      # E adjacency fetches of one round are
                                      # plane-parallel NAND page reads
    use_pq: bool = True               # False -> HNSW-style accurate traversal
    early_termination: bool = True
    rerank: bool = True
    use_pallas: bool = False          # not the kernels (the tensors' device
                                      # picks those); True makes a tiled
                                      # search's use_vmap=None unrolled


@dataclass(frozen=True)
class DatasetConfig:
    """Synthetic corpus spec (offline stand-ins for SIFT/GLOVE/DEEP)."""
    name: str = "sift-like"
    num_base: int = 10000
    num_queries: int = 256
    dim: int = 128
    metric: str = "l2"                # l2 | angular | ip
    num_clusters: int = 64
    cluster_std: float = 0.15
    seed: int = 0


@dataclass(frozen=True)
class StreamConfig:
    """Mutable-index (streaming) subsystem parameters.

    The delta segment is an in-memory append-only Vamana graph over freshly
    inserted vectors; once it exceeds ``consolidate_fraction`` of the base
    corpus, ``MutableIndex.consolidate()`` merges it into a rebuilt base
    index (re-running reorder / hot-node / gap-encode).
    """
    delta_capacity: int = 4096        # hard cap on delta-segment size
    consolidate_fraction: float = 0.25  # consolidate when delta/base exceeds
    delta_list_size: int = 32         # greedy-search list size inside delta
    brute_force_below: int = 64       # exact scan while the delta is tiny
    base_overfetch: int = 16          # extra base candidates (tombstone slack)


@dataclass(frozen=True)
class BuildConfig:
    """Segmented out-of-core index build (``repro.core.segmented``).

    ``segment_size == 0`` (default) builds the whole corpus as ONE segment —
    the legacy monolithic pipeline, bit-identical to ``core.build_index``.
    With ``segment_size > 0`` the corpus is consumed as a stream of
    fixed-size segments: the PQ codebook is trained once on a bounded
    reservoir sample, each segment gets its own proximity graph /
    visit-frequency reordering / gap encoding (working set bounded by the
    segment, not the corpus), and segments are cross-stitched through the
    streaming insert machinery (``repro.stream.stitch``).
    """
    segment_size: int = 0             # 0 -> single segment (monolithic)
    codebook_sample: int = 1 << 16    # reservoir cap for shared PQ training
    stitch_sample: int = 32           # boundary anchors patched per segment
    stitch_list_size: int = 0         # greedy-search list during stitching;
                                      # 0 -> density-compensated
                                      # build_list_size (x num_segments)


@dataclass(frozen=True)
class ShardConfig:
    """Multi-channel corpus partitioning (the shard layer, ``repro.shard``).

    ``num_tiles`` search tiles model independent NAND channel groups: cold
    vertices are partitioned by ``policy`` (contiguous | hash | cluster),
    hot nodes and PQ centroids are replicated on every tile
    (``replicate_hot``), and a query fans out to all tiles before a
    cross-tile top-k merge.
    """
    num_tiles: int = 1                # 1 -> single-tile (paper baseline)
    policy: str = "contiguous"        # contiguous | hash | cluster
    replicate_hot: bool = True        # paper's hot-node repetition per channel
    probe_tiles: int = 0              # 0 -> full fan-out; >0 -> route each
                                      # query to its nearest tiles (cluster
                                      # policy's IVF-style nprobe)


@dataclass(frozen=True)
class FilterConfig:
    """Filtered-search subsystem parameters (``repro.filter``).

    A ``FilterSpec`` compiles to a per-node boolean mask; the selectivity
    estimator routes each filtered query to one of two regimes:

      * moderate selectivity — masked graph traversal with an inflated
        effective ``list_size`` (non-passing nodes still route but cannot
        enter the result set, so the frontier must be wider to accumulate
        ``k`` passing candidates) and a relaxed early-termination threshold;
      * high selectivity (``<= brute_force_selectivity``) — a bitmap-driven
        brute-force PQ scan over the passing subset, exact-reranked.

    ``attr_bits`` is the per-node attribute word the NAND model bills as a
    spare-area read co-located with the adjacency page (predicate pushdown,
    see ``nand.simulator``).
    """
    attr_bits: int = 32               # spare-area attribute word per node
    brute_force_selectivity: float = 0.02  # <= this -> bitmap PQ scan
    inflate_cap: int = 8              # max list_size inflation (pow2-quantized)
    relax_repetition: int = 1         # extra stable rounds under a filter
    scan_rerank: int = 4              # scan mode reranks top scan_rerank*k
    pushdown: bool = True             # evaluate predicates inside the tile


@dataclass(frozen=True)
class ObsConfig:
    """Observability switches (``repro.obs``) — all OFF by default, so the
    serving hot path pays only a no-op branch per instrumented call site.
    ``Observability.resolve`` turns this into a live registry/tracer bundle
    (``ServingEngine(obs=ObsConfig(metrics=True, ...))``)."""
    metrics: bool = False             # counters / gauges / histograms
    tracing: bool = False             # per-request Chrome trace-event spans
    nand_billing: bool = False        # per-batch simulated NAND cost export
    # quality layer (repro.obs.quality / repro.obs.convergence)
    quality: bool = False             # shadow-recall sampling vs the exact
                                      # oracle, Wilson CIs (implies metrics)
    quality_sample_rate: float = 0.05  # fraction of live requests replayed
    quality_seed: int = 0             # sampling-stream seed (deterministic)
    convergence: bool = False         # per-round telemetry ring buffer
    convergence_capacity: int = 1 << 16  # ring size in records (oldest
                                         # dropped on overflow)


@dataclass(frozen=True)
class PlanConfig:
    """Query-plan layer parameters (``repro.plan``) — the single config the
    ``Searcher`` facade consumes, collapsing what used to be per-feature
    ``ServingEngine.__init__`` kwargs (num_tiles / shard_policy /
    probe_tiles / beam_width / ...) into one typed object.

    ``None`` fields defer to the index's own ``ProximaConfig`` (its
    ``search`` / ``shard`` / ``filter`` sections), so an empty ``PlanConfig``
    reproduces the index's configured serving mode exactly.
    """
    search: Optional["SearchConfig"] = None   # None -> index.config.search
    beam_width: Optional[int] = None          # override search.beam_width (E)
    num_tiles: Optional[int] = None           # None -> config.shard.num_tiles
    shard_policy: Optional[str] = None        # None -> config.shard.policy
    probe_tiles: Optional[int] = None         # None -> config.shard.probe_tiles
    filter: Optional["FilterConfig"] = None   # None -> config.filter
    bloom_bits: int = 1 << 17                 # traversal visited-set filter
    num_hashes: int = 8
    use_vmap: Optional[bool] = None           # tiled fan-out style (see shard)
    # distributed (device-mesh) execution ------------------------------------
    mode: str = "nsp"                         # nsp | fetch collective mode
    data_axis: str = "data"
    queue_axis: str = "model"


@dataclass(frozen=True)
class ProximaConfig:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    pq: PQConfig = field(default_factory=PQConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    build: BuildConfig = field(default_factory=BuildConfig)
    shard: ShardConfig = field(default_factory=ShardConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)
    hot_node_fraction: float = 0.03   # paper default 3%
    gap_encode: bool = True


def upgrade_config(cfg):
    """Fill in fields added to ``cfg``'s schema after it was pickled
    (benchmark index caches survive schema growth: a missing field gets its
    current default), recursing into nested config dataclasses so fields
    added to e.g. ``SearchConfig`` are filled even when the pickle predates
    them. Returns ``cfg`` unchanged when already complete — callers can rely
    on identity for the common no-op case. Non-dataclass values pass through
    untouched."""
    if not dataclasses.is_dataclass(cfg) or isinstance(cfg, type):
        return cfg
    cls = type(cfg)
    changed = {}
    for f in dataclasses.fields(cls):
        if not hasattr(cfg, f.name):
            continue  # missing -> cls(**present) fills the default below
        old = getattr(cfg, f.name)
        new = upgrade_config(old)
        if new is not old:
            changed[f.name] = new
    complete = all(hasattr(cfg, f.name) for f in dataclasses.fields(cls))
    if complete and not changed:
        return cfg
    kwargs = {
        f.name: changed.get(f.name, getattr(cfg, f.name))
        for f in dataclasses.fields(cls)
        if hasattr(cfg, f.name)
    }
    return cls(**kwargs)
