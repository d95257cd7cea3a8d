"""Model assembly: config -> param defs -> forward / prefill / decode / loss
(after ``repro.models.transformer``).

Parameters are a flat dict keyed by the reference's checkpoint flatten paths
(``embed``, ``groups/0/p0/attn/wq``, ``ln_f``, ``lm_head``), each block
group's layers stacked on a leading ``repeats`` axis; :class:`Transformer`
holds them as module parameters.  A ``for`` loop over the stacked layer index
takes the place of ``lax.scan``.  Global- and local-attention layers (dense
FFN), RWKV-6 layers and RG-LRU layers are ported for serving; every other
feature raises ``NotImplementedError`` when the model is built.  Training
(``loss_fn``) takes the attention and RWKV-6 layers: the RG-LRU kernel has
no backward yet.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
TRAINABLE_KINDS = ("global", "local", "rwkv")
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


def _layers(params: dict[str, torch.Tensor], prefix: str, repeats: int) -> list[dict]:
    """The ``repeats`` layers of the stacked params under ``prefix``, each a
    nested dict of views.  Each stack is split by one ``unbind``, so under
    autograd it gets one stacked gradient (a select a layer would add a
    full-size zero gradient of the stack for every layer)."""
    out: list[dict] = [{} for _ in range(repeats)]
    for path, t in params.items():
        if not path.startswith(prefix):
            continue
        *parents, leaf = path[len(prefix):].split("/")
        for layer, view in zip(out, t.unbind(0)):
            node = layer
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = view
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


# ---------------------------------------------------------------------------
# Functional passes over a flat param dict
# ---------------------------------------------------------------------------
def embed_tokens(params: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return params["embed"][tokens].to(dtype)


def unembed(params: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"].to(h.dtype).T
    return h @ params["lm_head"].to(h.dtype)


def _remat(cfg: ArchConfig) -> bool:
    """Whether to recompute each layer in the backward (only when grad is
    on): the reference's ``"full"`` policy remats each scan body, here each
    layer, through ``torch.utils.checkpoint``."""
    if not torch.is_grad_enabled() or cfg.remat_policy == "none":
        return False
    if cfg.remat_policy == "full":
        return True
    raise NotImplementedError(f"remat_policy {cfg.remat_policy!r} is not ported yet")


def run_groups(params: dict, cfg: ArchConfig, h: torch.Tensor, *, causal: bool = True,
               positions: Optional[torch.Tensor] = None, collect_cache: bool = False):
    """Apply all block groups. Returns (h, caches|None); each group's cache
    is {"p{i}": entry}, each tensor of the layer's entry ({"k", "v"}, {"S",
    "ts1", "ts2"} or {"h", "conv"}) stacked over the group's layers. A
    recurrent layer's state is written straight into its slice of the
    stack."""
    caches = []
    remat = not collect_cache and _remat(cfg)
    for g, (pattern, repeats) in enumerate(cfg.block_groups):
        cache_g = {}
        layers = [_layers(params, f"groups/{g}/p{i}/", repeats) for i in range(len(pattern))]
        for r in range(repeats):
            for i, kind in enumerate(pattern):
                apply = functools.partial(apply_layer, cfg, kind, causal=causal,
                                          positions=positions)
                if not collect_cache:
                    h = (checkpoint(apply, layers[i][r], h, use_reentrant=False) if remat
                         else apply(layers[i][r], h))[0]
                    continue
                state = None
                if kind in RECURRENT:
                    if r == 0:
                        cache_g[f"p{i}"] = RECURRENT[kind][1](
                            cfg, h.shape[0], h.device, stack=repeats)
                    state = {name: t[r] for name, t in cache_g[f"p{i}"].items()}
                h, entry = apply(layers[i][r], h, state=state)
                if kind in RECURRENT:
                    continue
                if r == 0:
                    cache_g[f"p{i}"] = {
                        name: torch.empty((repeats,) + t.shape, dtype=t.dtype, device=t.device)
                        for name, t in entry.items()}
                for name, t in entry.items():
                    cache_g[f"p{i}"][name][r] = t
        caches.append(cache_g)
    return h, (caches if collect_cache else None)


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *, dtype: torch.dtype,
            collect_cache: bool = False):
    """tokens (B, S) -> (final-normed h in ``dtype``, caches|None)."""
    h = embed_tokens(params, tokens, dtype)
    positions = torch.arange(h.shape[1], device=h.device)
    h, caches = run_groups(params, cfg, h, causal=True, positions=positions,
                           collect_cache=collect_cache)
    return rms_norm(h, params["ln_f"], cfg.norm_eps), caches


# ---------------------------------------------------------------------------
# Loss (sequence-chunked cross entropy; bounds logits memory at
# B x loss_chunk x vocab instead of B x S x vocab)
# ---------------------------------------------------------------------------
def lm_loss(params: dict, cfg: ArchConfig, h: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy over the mask plus the 1e-4 z-loss;
    chunks of ``loss_chunk`` positions are recomputed in the backward."""
    B, S, _ = h.shape
    chunk = cfg.loss_chunk if cfg.loss_chunk and S % cfg.loss_chunk == 0 else S
    nc = S // chunk
    vocab = torch.arange(cfg.vocab_size, device=h.device)

    def ce(hc, lc, mc):
        logits = unembed(params, cfg, hc).float()
        logz = torch.logsumexp(logits, dim=-1)
        # the label's logit as the reference takes it: a one-hot product
        lab = torch.where(vocab == lc[..., None], logits, 0.0).sum(-1)
        nll = (logz - lab) * mc
        zl = 1e-4 * torch.square(logz) * mc
        return nll.sum(), zl.sum(), mc.sum()

    mask = mask.float()
    if nc == 1:
        nll, zl, cnt = ce(h, labels, mask)
    else:
        run = (lambda *a: checkpoint(ce, *a, use_reentrant=False)) \
            if torch.is_grad_enabled() else ce
        nll = zl = cnt = torch.zeros((), device=h.device)
        for c in range(nc):
            part = slice(c * chunk, (c + 1) * chunk)
            n, z, m = run(h[:, part], labels[:, part], mask[:, part])
            nll, zl, cnt = nll + n, zl + z, cnt + m
    cnt = torch.clamp(cnt, min=1.0)
    loss = nll / cnt
    metrics = {"ce_loss": loss, "z_loss": zl / cnt, "tokens": cnt}
    return loss + zl / cnt, metrics


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Compute-precision view of the master weights, cast once a step;
    gradients flow through the cast back to the masters."""
    return {path: t.to(dtype) if t.is_floating_point() else t for path, t in params.items()}


def check_trainable(cfg: ArchConfig) -> None:
    for kind in cfg.layer_kinds():
        if kind not in TRAINABLE_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: training {kind!r} layers needs a backward kernel that is not "
                "ported yet")


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *,
            dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """Scalar training loss and metrics; batch["tokens"] is (B, S + 1),
    shifted into inputs and labels; batch["mask"] (B, S) is optional."""
    check_trainable(cfg)
    params = cast_params(params, dtype)
    tokens = batch["tokens"]
    labels = tokens[:, 1:]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    h, _ = forward(params, cfg, tokens[:, :-1], dtype=dtype)
    loss, metrics = lm_loss(params, cfg, h, labels, mask)
    metrics["loss"] = loss
    return loss, metrics


class Transformer(nn.Module):
    """Decoder-only model (global or local attention, RWKV-6 and RG-LRU
    layers) with stacked per-group weights, for serving.

    ``dtype`` is the compute dtype and the dtype of the weights and caches;
    the weights are frozen.  Weights are random from ``seed``;
    ``load_state_dict`` (keyed by flatten path) replaces them.  Training
    runs on a flat dict of f32 masters through :func:`loss_fn`.
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

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_tokens(self.flat, tokens, self.dtype)

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        return unembed(self.flat, self.cfg, h)

    def run_groups_decode(self, h: torch.Tensor, cache_groups: list, pos: int):
        flat = self.flat
        for g, ((pattern, repeats), gcache) in enumerate(
                zip(self.cfg.block_groups, cache_groups)):
            layers = [_layers(flat, f"groups/{g}/p{i}/", repeats) for i in range(len(pattern))]
            for r in range(repeats):
                for i, kind in enumerate(pattern):
                    layer_cache = {name: t[r] for name, t in gcache[f"p{i}"].items()}
                    h, _ = decode_apply_layer(self.cfg, kind, layers[i][r], h, layer_cache, pos)
        return h, cache_groups

    def forward(self, tokens: torch.Tensor, *, collect_cache: bool = False):
        """tokens (B, S) -> (final-normed h, caches|None)."""
        return forward(self.flat, self.cfg, tokens, dtype=self.dtype,
                       collect_cache=collect_cache)

    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One decode step. tokens (B, 1). Returns (logits, cache); the
        cache's tensors are updated in place."""
        pos = cache["pos"]
        h = self.embed_tokens(tokens)
        h, groups = self.run_groups_decode(h, cache["groups"], pos)
        h = rms_norm(h, self.get_parameter("ln_f"), self.cfg.norm_eps)
        return self.unembed(h), {"pos": pos + 1, "groups": groups}
