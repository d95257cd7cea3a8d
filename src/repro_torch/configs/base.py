"""Architecture and shape configuration schema (copy of ``repro.configs.base``).

Layers are organised into *block groups*: ``(pattern, repeats)`` pairs.  The
port runs each group as a Python loop over the stacked layer index.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# Layer kinds understood by the model zoo.
ATTN_KINDS = ("global", "local", "chunked")
LAYER_KINDS = ATTN_KINDS + ("rglru", "rwkv")


@dataclass(frozen=True)
class MoESpec:
    """Mixture-of-Experts FFN replacing the dense FFN."""

    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False
    group_size: int = 1024
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class RGLRUSpec:
    """RecurrentGemma RG-LRU recurrent block."""

    lru_width: int
    conv_width: int = 4
    n_heads: int = 16


@dataclass(frozen=True)
class RWKVSpec:
    """RWKV-6 (Finch) time-mix / channel-mix block."""

    head_dim: int = 64
    ddlerp_rank: int = 32
    decay_rank: int = 64


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell."""

    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # Block structure: ((pattern, repeats), ...). sum(len(p)*r) == n_layers.
    block_groups: tuple[tuple[tuple[str, ...], int], ...] = ((("global",), 0),)

    # Attention options.
    window: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0

    # Sub-family specs.
    moe: Optional[MoESpec] = None
    rglru: Optional[RGLRUSpec] = None
    rwkv: Optional[RWKVSpec] = None

    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len_ratio: float = 1.0

    n_patches: int = 0

    tie_embeddings: bool = False
    ffn_gated: bool = True  # SwiGLU (3 matmuls) vs classic MLP (2 matmuls)
    norm_eps: float = 1e-5
    long_context_ok: bool = False

    remat_policy: str = "full"
    loss_chunk: int = 2048
    notes: str = ""
    source: str = ""

    def __post_init__(self) -> None:
        total = sum(len(p) * r for p, r in self.block_groups)
        if total != self.n_layers:
            raise ValueError(
                f"{self.name}: block_groups cover {total} layers, expected {self.n_layers}"
            )
        for pattern, _ in self.block_groups:
            for kind in pattern:
                if kind not in LAYER_KINDS:
                    raise ValueError(f"{self.name}: unknown layer kind {kind!r}")

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def layer_kinds(self) -> list[str]:
        out: list[str] = []
        for pattern, repeats in self.block_groups:
            out.extend(list(pattern) * repeats)
        return out

    def count_kind(self, *kinds: str) -> int:
        return sum(1 for k in self.layer_kinds() if k in kinds)

    # -- parameter accounting (the reference's, for logs and sizing) -------
    def attn_params(self) -> int:
        d = self.d_model
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def ffn_params(self) -> int:
        # SwiGLU: gate, up, down; classic MLP: up, down.
        dense = (3 if self.ffn_gated else 2) * self.d_model * self.d_ff
        if self.moe is None:
            return dense
        routed = self.moe.n_experts * dense + self.d_model * self.moe.n_experts
        if self.moe.shared_expert:
            routed += dense
        return routed

    def ffn_active_params(self) -> int:
        """The FFN parameters one token runs through: top_k experts (and
        the shared one) of an MoE FFN, and its router."""
        dense = (3 if self.ffn_gated else 2) * self.d_model * self.d_ff
        if self.moe is None:
            return dense
        active = self.moe.top_k * dense + self.d_model * self.moe.n_experts
        if self.moe.shared_expert:
            active += dense
        return active

    def rglru_params(self) -> int:
        assert self.rglru is not None
        w = self.rglru.lru_width
        d = self.d_model
        conv = self.rglru.conv_width * w
        gates = 2 * (w * w // self.rglru.n_heads)  # block-diagonal a/i gates
        return 2 * d * w + w * d + conv + gates + 2 * w  # in(x2), out, conv, gates, lambda+bias

    def rwkv_params(self) -> int:
        assert self.rwkv is not None
        d = self.d_model
        r = self.rwkv.ddlerp_rank
        time_mix = 4 * d * d + d * d  # r,k,v,g,out
        ddlerp = 5 * (d * r + r * d) + 6 * d
        decay = d * self.rwkv.decay_rank + self.rwkv.decay_rank * d + 2 * d
        channel_mix = 2 * d * self.d_ff + 2 * d
        return time_mix + ddlerp + decay + channel_mix

    def _layer_params(self, kind: str) -> int:
        norms = 2 * self.d_model
        if kind in ATTN_KINDS:
            return self.attn_params() + self.ffn_params() + norms
        if kind == "rglru":
            return self.rglru_params() + self.ffn_params() + norms
        if kind == "rwkv":
            return self.rwkv_params() + norms
        raise ValueError(kind)

    def _layer_active_params(self, kind: str) -> int:
        norms = 2 * self.d_model
        if kind in ATTN_KINDS:
            return self.attn_params() + self.ffn_active_params() + norms
        if kind == "rglru":
            return self.rglru_params() + self.ffn_active_params() + norms
        if kind == "rwkv":
            return self.rwkv_params() + norms
        raise ValueError(kind)

    def param_count(self) -> int:
        n = sum(self._layer_params(k) for k in self.layer_kinds())
        n += self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model  # lm head
        n += self.d_model  # final norm
        if self.enc_dec:
            # encoder self-attn+ffn layers and decoder cross-attn additions
            enc = self.n_enc_layers * (self.attn_params() + self.ffn_params() + 2 * self.d_model)
            cross = self.count_kind(*ATTN_KINDS) * (self.attn_params() + self.d_model)
            n += enc + cross + self.d_model
        return n

    def active_param_count(self) -> int:
        """Parameters a token runs through (N of the 6 N D rule); the
        encoder's FFNs count whole, as the reference counts them."""
        n = sum(self._layer_active_params(k) for k in self.layer_kinds())
        n += self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        n += self.d_model
        if self.enc_dec:
            enc = self.n_enc_layers * (self.attn_params() + self.ffn_params() + 2 * self.d_model)
            cross = self.count_kind(*ATTN_KINDS) * (self.attn_params() + self.d_model)
            n += enc + cross + self.d_model
        return n

    def kv_cache_len(self, kind: str, seq_len: int) -> int:
        if kind == "global":
            return seq_len
        if kind in ("local", "chunked"):
            return min(self.window, seq_len) if self.window else seq_len
        return 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(k for k in _REGISTRY if not k.startswith("__"))


def _ensure_loaded() -> None:
    import importlib

    if _REGISTRY.get("__loaded__"):
        return
    for mod in ("gemma3_4b", "granite_20b", "llama4_scout_17b_a16e", "llava_next_34b",
                "mixtral_8x22b", "qwen3_0_6b", "recurrentgemma_9b", "rsc_llm", "rwkv6_7b",
                "seamless_m4t_large_v2", "starcoder2_3b"):
        importlib.import_module(f"repro_torch.configs.{mod}")
    _REGISTRY["__loaded__"] = True  # type: ignore[assignment]


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests (same rule as the
    reference, so both packages build identical smoke models)."""
    scale_heads = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_kv = 2 if cfg.n_kv_heads > 1 else 1
    n_heads = n_kv * min(scale_heads, 4)
    groups = tuple((pattern, min(repeats, 2)) for pattern, repeats in cfg.block_groups)
    n_layers = sum(len(p) * r for p, r in groups)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=min(cfg.moe.n_experts, 4), group_size=64)
    rglru = None
    if cfg.rglru is not None:
        rglru = dataclasses.replace(cfg.rglru, lru_width=64, n_heads=4)
    rwkv = None
    if cfg.rwkv is not None:
        rwkv = dataclasses.replace(cfg.rwkv, head_dim=16, ddlerp_rank=8, decay_rank=8)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        block_groups=groups,
        window=min(cfg.window, 64) if cfg.window else 0,
        moe=moe,
        rglru=rglru,
        rwkv=rwkv,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_patches=min(cfg.n_patches, 16),
        loss_chunk=0,
    )
