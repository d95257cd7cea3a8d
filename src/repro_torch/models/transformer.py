"""Model assembly: config -> param defs -> forward / prefill / decode (after
``repro.models.transformer``).

:class:`Transformer` holds the weights as parameters named by the reference's
checkpoint flatten paths (``embed``, ``groups/0/p0/attn/wq``, ``ln_f``,
``lm_head``), each block group's layers stacked on a leading ``repeats`` axis.
A ``for`` loop over the stacked layer index takes the place of ``lax.scan``.
Global- and local-attention layers (dense FFN), RWKV-6 layers and RG-LRU
layers are ported; every other feature raises ``NotImplementedError`` when
the model is built.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import params as pmod
from repro_torch.models import recurrent
from repro_torch.models.layers import (
    attention_defs,
    decode_self_attention,
    ffn,
    ffn_defs,
    rms_norm,
    self_attention,
)
from repro_torch.models.params import ParamDef


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------
PORTED_KINDS = ("global", "local", "rwkv", "rglru")
# recurrent kinds: (block, zero state); the block updates a given state in place
RECURRENT = {"rwkv": (recurrent.rwkv_block, recurrent.rwkv_init_state),
             "rglru": (recurrent.rglru_block, recurrent.rglru_init_state)}


def layer_defs(cfg: ArchConfig, kind: str) -> dict:
    if kind == "rwkv":
        return recurrent.rwkv_defs(cfg)
    if kind == "rglru":
        return recurrent.rglru_defs(cfg)
    d = cfg.d_model
    return {
        "ln1": ParamDef((d,), init="ones"),
        "attn": attention_defs(cfg),
        "ln2": ParamDef((d,), init="ones"),
        "ffn": ffn_defs(cfg),
    }


def _stack(defs: Any, n: int) -> Any:
    if isinstance(defs, dict):
        return {k: _stack(v, n) for k, v in defs.items()}
    return dataclasses.replace(defs, shape=(n,) + defs.shape)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for every feature outside the ported slices: dense global and
    local attention, RWKV-6 and RG-LRU."""
    unsupported = {
        "MoE": cfg.moe is not None,
        "enc_dec": cfg.enc_dec,
        "n_patches": cfg.n_patches > 0,
        "attn_logit_softcap > 0": cfg.attn_logit_softcap > 0,
    }
    for name, hit in unsupported.items():
        if hit:
            raise NotImplementedError(f"{cfg.name}: {name} is not ported yet")
    for kind in cfg.layer_kinds():
        if kind not in PORTED_KINDS:
            raise NotImplementedError(f"{cfg.name}: {kind!r} layers are not ported yet")


def model_defs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    groups = [
        {f"p{i}": _stack(layer_defs(cfg, kind), repeats) for i, kind in enumerate(pattern)}
        for pattern, repeats in cfg.block_groups
    ]
    defs: dict[str, Any] = {
        "embed": ParamDef((V, d)),
        "groups": groups,
        "ln_f": ParamDef((d,), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, V))
    return defs


def _nest(flat: dict[str, torch.Tensor], prefix: str, r: int) -> dict:
    """Layer ``r`` of the stacked params under ``prefix`` as a nested dict
    of views."""
    out: dict = {}
    for path, t in flat.items():
        if not path.startswith(prefix):
            continue
        *parents, leaf = path[len(prefix):].split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t[r]
    return out


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------
def apply_layer(cfg: ArchConfig, kind: str, p: dict, h: torch.Tensor, *,
                causal: bool = True, positions: Optional[torch.Tensor] = None,
                state: Optional[dict] = None):
    """Full-sequence layer. Returns (h, cache entry): {"k", "v"} (the last
    ``kv_cache_len`` positions) for attention, the final state for rwkv and
    rglru (written into ``state`` when it is given, zeros on entry)."""
    if kind in RECURRENT:
        return RECURRENT[kind][0](p, h, cfg, state=state)
    a_out, (k, v) = self_attention(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), cfg, kind,
        causal=causal, positions=positions)
    h = h + a_out
    h = h + ffn(p["ffn"], rms_norm(h, p["ln2"], cfg.norm_eps))
    L = cfg.kv_cache_len(kind, k.shape[1])
    return h, {"k": k[:, -L:], "v": v[:, -L:]}


def decode_apply_layer(cfg: ArchConfig, kind: str, p: dict, h: torch.Tensor,
                       cache: dict, pos: int):
    """One-token layer. Updates ``cache`` in place and returns (h, cache)."""
    if kind in RECURRENT:
        return RECURRENT[kind][0](p, h, cfg, state=cache)
    a_out, cache["k"], cache["v"] = decode_self_attention(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), cfg, kind,
        cache["k"], cache["v"], pos)
    h = h + a_out
    h = h + ffn(p["ffn"], rms_norm(h, p["ln2"], cfg.norm_eps))
    return h, cache


class Transformer(nn.Module):
    """Decoder-only model (global or local attention, RWKV-6 and RG-LRU
    layers) with stacked per-group weights.

    ``dtype`` is the compute dtype and the dtype of the weights and caches.
    Weights are random from ``seed``; ``load_state_dict`` (keyed by flatten
    path) replaces them.
    """

    def __init__(self, cfg: ArchConfig, *, device: torch.device | str,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        defs = pmod.cast_defs(model_defs(cfg), dtype)
        for path, t in pmod.materialize(defs, seed=seed, device=device).items():
            self.register_parameter(path, nn.Parameter(t, requires_grad=False))

    @property
    def flat(self) -> dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    # -- embedding ---------------------------------------------------------
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.get_parameter("embed")[tokens].to(self.dtype)

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return h @ self.get_parameter("embed").to(h.dtype).T
        return h @ self.get_parameter("lm_head").to(h.dtype)

    # -- group runners -----------------------------------------------------
    def run_groups(self, h: torch.Tensor, *, causal: bool = True,
                   positions: Optional[torch.Tensor] = None,
                   collect_cache: bool = False):
        """Apply all block groups. Returns (h, caches|None); each group's
        cache is {"p{i}": entry}, each tensor of the layer's entry ({"k", "v"},
        {"S", "ts1", "ts2"} or {"h", "conv"}) stacked over the group's
        layers. A recurrent layer's state is written straight into its
        slice of the stack."""
        flat = self.flat
        caches = []
        for g, (pattern, repeats) in enumerate(self.cfg.block_groups):
            cache_g = {}
            for r in range(repeats):
                for i, kind in enumerate(pattern):
                    p = _nest(flat, f"groups/{g}/p{i}/", r)
                    state = None
                    if collect_cache and kind in RECURRENT:
                        if r == 0:
                            cache_g[f"p{i}"] = RECURRENT[kind][1](
                                self.cfg, h.shape[0], h.device, stack=repeats)
                        state = {name: t[r] for name, t in cache_g[f"p{i}"].items()}
                    h, entry = apply_layer(self.cfg, kind, p, h, causal=causal,
                                           positions=positions, state=state)
                    if not collect_cache or kind in RECURRENT:
                        continue
                    if r == 0:
                        cache_g[f"p{i}"] = {
                            name: torch.empty((repeats,) + t.shape, dtype=t.dtype,
                                              device=t.device)
                            for name, t in entry.items()}
                    for name, t in entry.items():
                        cache_g[f"p{i}"][name][r] = t
            caches.append(cache_g)
        return h, (caches if collect_cache else None)

    def run_groups_decode(self, h: torch.Tensor, cache_groups: list, pos: int):
        flat = self.flat
        for g, ((pattern, repeats), gcache) in enumerate(
                zip(self.cfg.block_groups, cache_groups)):
            for r in range(repeats):
                for i, kind in enumerate(pattern):
                    p = _nest(flat, f"groups/{g}/p{i}/", r)
                    layer_cache = {name: t[r] for name, t in gcache[f"p{i}"].items()}
                    h, _ = decode_apply_layer(self.cfg, kind, p, h, layer_cache, pos)
        return h, cache_groups

    # -- full passes -------------------------------------------------------
    def forward(self, tokens: torch.Tensor, *, collect_cache: bool = False):
        """tokens (B, S) -> (final-normed h, caches|None)."""
        h = self.embed_tokens(tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        h, caches = self.run_groups(h, causal=True, positions=positions,
                                    collect_cache=collect_cache)
        h = rms_norm(h, self.get_parameter("ln_f"), self.cfg.norm_eps)
        return h, caches

    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One decode step. tokens (B, 1). Returns (logits, cache); the
        cache's tensors are updated in place."""
        pos = cache["pos"]
        h = self.embed_tokens(tokens)
        h, groups = self.run_groups_decode(h, cache["groups"], pos)
        h = rms_norm(h, self.get_parameter("ln_f"), self.cfg.norm_eps)
        return self.unembed(h), {"pos": pos + 1, "groups": groups}
