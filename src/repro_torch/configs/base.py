"""Architecture configuration schema (copy of ``repro.configs.base``).

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
    for mod in ("gemma3_4b", "granite_20b", "llama4_scout_17b_a16e", "mixtral_8x22b",
                "qwen3_0_6b", "recurrentgemma_9b", "rsc_llm", "rwkv6_7b", "starcoder2_3b"):
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
