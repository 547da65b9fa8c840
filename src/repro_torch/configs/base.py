"""Config dataclasses + registry for all selectable architectures.

Every assigned architecture gets one module in ``repro_torch/configs/<id>.py``
that instantiates an :class:`ArchSpec` with the exact published
configuration and its assigned input-shape set.  The registry maps
``--arch <id>`` to the spec.  The package is framework-free: the port keeps
its own copy of the reference's ``repro.configs``, value for value.

Families:
  * ``lm``      — decoder-only transformers (dense + MoE).
  * ``gnn``     — message-passing GNNs (GAT).
  * ``recsys``  — CTR / retrieval models over sparse embedding tables.
  * ``cf``      — the paper's own neighbourhood-CF system (TwinSearch).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping


# ---------------------------------------------------------------------------
# Shape specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell of the (arch x shape) matrix.

    ``kind`` selects which step function is lowered:
      * lm:     ``train`` -> train_step, ``prefill`` -> prefill_step,
                ``decode`` -> serve_step (1 new token against a KV cache).
      * gnn:    ``train_full`` / ``train_sampled`` / ``train_batched``.
      * recsys: ``train`` / ``serve`` / ``retrieval``.
      * cf:     ``build`` (full similarity build) / ``onboard`` (TwinSearch).

    ``skip`` holds a human-readable reason when a cell is skipped for an
    architecture (e.g. long-context decode on a pure full-attention model).
    """

    name: str
    kind: str
    dims: Mapping[str, Any] = field(default_factory=dict)

    def dim(self, key: str, default: Any = None) -> Any:
        return self.dims.get(key, default)


# ---------------------------------------------------------------------------
# Per-family model configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # shared (always-on) experts
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    act: str = "swiglu"                 # swiglu | geglu | gelu
    moe: MoEConfig | None = None
    # Attention pattern: window=None -> full attention everywhere.
    # window=W with global_every=G -> layers l where (l+1) % G == 0 are
    # global-attention, all others are sliding-window of size W
    # (Gemma-3's 5:1 local:global, Llama-4's 3:1 chunked:NoPE-global).
    window: int | None = None
    global_every: int | None = None
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    embed_scale: bool = False           # Gemma-style sqrt(d_model) embed scaling
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    # Activation sharding: shard the sequence axis of inter-block activations
    # over the model axis (Megatron sequence-parallel analogue under GSPMD).
    seq_shard: bool = True

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Total parameter count (exact, matching init_params)."""
        d, L = self.d_model, self.n_layers
        embed = self.vocab_size * d
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.moe is not None:
            m = self.moe
            glu = 3 if self.act in ("swiglu", "geglu") else 2
            expert = glu * d * m.d_ff_expert
            ffn = m.n_experts * expert + m.n_shared * expert + d * m.n_experts
        else:
            glu = 3 if self.act in ("swiglu", "geglu") else 2
            ffn = glu * d * self.d_ff
        norms = 2 * d * L + d
        out = 0 if self.tie_embeddings else self.vocab_size * d
        return embed + L * (attn + ffn) + norms + out

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d, L = self.d_model, self.n_layers
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        expert = glu * d * m.d_ff_expert
        dense_total = self.param_count() - L * (m.n_experts - 0) * expert
        return dense_total + L * (m.top_k) * expert


@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    n_heads: int
    aggregator: str = "attn"            # GAT
    n_classes: int = 7
    negative_slope: float = 0.2
    dtype: str = "float32"


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    variant: str                        # bst | xdeepfm | autoint | two_tower
    embed_dim: int
    # Sparse feature layout: one concatenated table; vocab per field.
    field_vocab_sizes: tuple[int, ...] = ()
    n_dense: int = 0
    mlp_dims: tuple[int, ...] = ()
    # xDeepFM
    cin_layers: tuple[int, ...] = ()
    # AutoInt
    n_attn_layers: int = 0
    n_attn_heads: int = 0
    d_attn: int = 0
    # BST
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    item_vocab: int = 0
    # two-tower
    tower_mlp: tuple[int, ...] = ()
    user_vocab: int = 0
    dtype: str = "float32"

    @property
    def n_sparse(self) -> int:
        return len(self.field_vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.field_vocab_sizes))


@dataclass(frozen=True)
class CFConfig:
    """The paper's neighbourhood-CF system (sizes live in the ShapeSpec)."""

    name: str
    mode: str = "user"                   # user-based or item-based CF
    similarity: str = "cosine"
    c_probes: int = 8
    # Static candidate bound: ceil(n / set0_divisor) * slack. 125 is the
    # paper's Gaussian-analysis bound (Sec 3.2); slack absorbs ties.
    set0_divisor: int = 125
    set0_slack: float = 1.5
    sim_tol: float = 0.0
    dtype: str = "float32"


# ---------------------------------------------------------------------------
# ArchSpec + registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                          # lm | gnn | recsys | cf
    config: Any
    shapes: tuple[ShapeSpec, ...]
    source: str = ""
    notes: str = ""
    # shape name -> reason, for cells that must be skipped for this arch.
    skip_shapes: Mapping[str, str] = field(default_factory=dict)

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {name!r}; "
                       f"have {[s.name for s in self.shapes]}")

    def active_shapes(self) -> tuple[ShapeSpec, ...]:
        return tuple(s for s in self.shapes if s.name not in self.skip_shapes)


_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    if spec.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch id {spec.arch_id}")
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}")


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False

_CONFIG_MODULES = (
    "olmoe_1b_7b",
    "llama4_scout_17b_a16e",
    "gemma3_1b",
    "granite_20b",
    "gemma_7b",
    "gat_cora",
    "bst",
    "xdeepfm",
    "autoint",
    "two_tower_retrieval",
    "twinsearch_cf",
)


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in _CONFIG_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True


# ---------------------------------------------------------------------------
# Shared shape sets
# ---------------------------------------------------------------------------

LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4_096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32_768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32_768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524_288, "global_batch": 1}),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "train_full",
              {"n_nodes": 2_708, "n_edges": 10_556, "d_feat": 1_433}),
    ShapeSpec("minibatch_lg", "train_sampled",
              {"n_nodes": 232_965, "n_edges": 114_615_892,
               "batch_nodes": 1_024, "fanout": (15, 10), "d_feat": 602}),
    ShapeSpec("ogb_products", "train_full",
              {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100}),
    ShapeSpec("molecule", "train_batched",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16}),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65_536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262_144}),
    ShapeSpec("retrieval_cand", "retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
)

CF_SHAPES = (
    ShapeSpec("ml_build", "build", {"n_users": 943, "n_items": 1_682}),
    ShapeSpec("douban_build", "build", {"n_users": 129_490, "n_items": 58_541}),
    ShapeSpec("douban_onboard", "onboard",
              {"n_users": 129_490, "n_items": 58_541, "k_new": 30}),
    ShapeSpec("webscale_onboard", "onboard",
              {"n_users": 524_288, "n_items": 131_072, "k_new": 64}),
)

FULL_ATTN_LONG_SKIP = ("pure full attention: 500k-context cell assigned only "
                       "to sub-quadratic (local/chunked/SSM) architectures")


def pad_to_shard(n: int, multiple: int = 512) -> int:
    """Round a dimension up to the shard boundary (512 = max devices on the
    production meshes).  Tables / node stores / edge lists / similarity
    capacities pad to this so row-sharding over any axis subset divides
    evenly — the padding rows are dead weight (< 0.4%) masked by counts."""
    return -(-n // multiple) * multiple
