"""Model assembly: config -> param defs -> forward / prefill / decode / loss
(after ``repro.models.transformer``).

Parameters are a flat dict keyed by the reference's checkpoint flatten paths
(``embed``, ``groups/0/p0/attn/wq``, ``ln_f``, ``lm_head``), each block
group's layers stacked on a leading ``repeats`` axis; :class:`Transformer`
holds them as module parameters.  A ``for`` loop over the stacked layer index
takes the place of ``lax.scan``.  Every layer kind of the reference is
ported: global-, local- and chunked-attention layers (dense or MoE FFN,
logits optionally softcapped), RWKV-6 layers and RG-LRU layers, with the
encoder-decoder form (a bidirectional encoder over stubbed frame
embeddings, cross-attention in every decoder layer) and the VLM form
(stubbed patch embeddings in front of the tokens).  Each of them serves
and trains (``loss_fn``): attention through the ``FlashAttention``
Function, RWKV-6 through ``WKV6`` and RG-LRU through ``RGLRU``, each a
forward kernel and a backward kernel on the card.  The MoE FFN's aux
losses are summed over the layers as the reference's scan carries them
(``AUX_KEYS``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ATTN_KINDS, ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import params as pmod
from repro_torch.models import recurrent
from repro_torch.models.layers import (
    attention_defs,
    cross_attention,
    decode_cross_attention,
    decode_self_attention,
    ffn,
    ffn_defs,
    moe_defs,
    moe_ffn,
    rms_norm,
    self_attention,
    SITES,
)
from repro_torch.models.params import ParamDef
from repro_torch.parallel.axes import (constrain, distribute_as, gather_fsdp,
                                      plain_as_replicated, recompute_contexts)


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------
PORTED_KINDS = ("global", "local", "chunked", "rwkv", "rglru")  # each serves and trains
AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_dropped_frac")
# recurrent kinds: (block, zero state); the block updates a given state in place
RECURRENT = {"rwkv": (recurrent.rwkv_block, recurrent.rwkv_init_state),
             "rglru": (recurrent.rglru_block, recurrent.rglru_init_state)}


def layer_defs(cfg: ArchConfig, kind: str, with_cross: bool = False) -> dict:
    if kind == "rwkv":
        return recurrent.rwkv_defs(cfg)
    if kind == "rglru":
        return recurrent.rglru_defs(cfg)
    d = cfg.d_model
    defs = {
        "ln1": ParamDef((d,), ("embed",), init="ones"),
        "attn": attention_defs(cfg),
        "ln2": ParamDef((d,), ("embed",), init="ones"),
    }
    if cfg.moe is not None:
        defs["moe"] = moe_defs(cfg)
    else:
        defs["ffn"] = ffn_defs(cfg)
    if with_cross:
        defs["ln_x"] = ParamDef((d,), ("embed",), init="ones")
        defs["xattn"] = attention_defs(cfg, cross=True)
    return defs


def _stack(defs: Any, n: int) -> Any:
    if isinstance(defs, dict):
        return {k: _stack(v, n) for k, v in defs.items()}
    return dataclasses.replace(defs, shape=(n,) + defs.shape, axes=("layers",) + defs.axes)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a layer kind the port does not know."""
    for kind in cfg.layer_kinds():
        if kind not in PORTED_KINDS:
            raise NotImplementedError(f"{cfg.name}: {kind!r} layers are not ported yet")


def model_defs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    groups = [
        {f"p{i}": _stack(layer_defs(cfg, kind, with_cross=cfg.enc_dec), repeats)
         for i, kind in enumerate(pattern)}
        for pattern, repeats in cfg.block_groups
    ]
    defs: dict[str, Any] = {
        "embed": ParamDef((V, d), ("vocab", "embed")),
        "groups": groups,
        "ln_f": ParamDef((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, V), ("embed", "vocab"))
    if cfg.enc_dec:
        defs["encoder"] = {
            "blocks": _stack(layer_defs(cfg, "global"), cfg.n_enc_layers),
            "ln_f": ParamDef((d,), ("embed",), init="ones"),
        }
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
def _ffn_out(cfg: ArchConfig, p: dict, hn: torch.Tensor):
    """The layer's FFN on the normed stream: (out, aux (len(AUX_KEYS),) f32
    for an MoE FFN, else None)."""
    if "moe" not in p:
        return ffn(p["ffn"], hn), None
    out, aux = moe_ffn(p["moe"], hn, cfg)
    return out, torch.stack([aux[k].float() for k in AUX_KEYS])


def apply_layer(cfg: ArchConfig, kind: str, p: dict, h: torch.Tensor, *,
                causal: bool = True, positions: Optional[torch.Tensor] = None,
                state: Optional[dict] = None, enc_out: Optional[torch.Tensor] = None):
    """Full-sequence layer. Returns (h, aux, cache entry): aux as
    ``_ffn_out`` gives it (None outside an MoE FFN); the entry {"k", "v"}
    (the last ``kv_cache_len`` positions) for attention, with the
    cross-attention's encoder keys and values {"xk", "xv"} when ``enc_out``
    is given; the final state for rwkv and rglru (written into ``state``
    when it is given, zeros on entry).  On a mesh the layer's weights are
    gathered over the FSDP dims first (``gather_fsdp``)."""
    p = gather_fsdp(p)
    if kind in RECURRENT:
        h, entry = RECURRENT[kind][0](p, h, cfg, state=state)
        return h, None, entry
    a_out, (k, v) = self_attention(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), cfg, kind,
        causal=causal, positions=positions)
    h = h + a_out
    entry = {}
    if enc_out is not None:
        x_out, (entry["xk"], entry["xv"]) = cross_attention(
            p["xattn"], rms_norm(h, p["ln_x"], cfg.norm_eps), enc_out, cfg)
        h = h + x_out
    f_out, aux = _ffn_out(cfg, p, rms_norm(h, p["ln2"], cfg.norm_eps))
    L = cfg.kv_cache_len(kind, k.shape[1])
    return h + f_out, aux, {"k": k[:, -L:], "v": v[:, -L:], **entry}


def decode_apply_layer(cfg: ArchConfig, kind: str, p: dict, h: torch.Tensor,
                       cache: dict, pos: int):
    """One-token layer. Updates ``cache`` in place and returns (h, cache);
    an MoE FFN's aux is dropped, as the reference drops it.  A cache with
    encoder keys and values ("xk", "xv", read only) adds cross-attention."""
    p = gather_fsdp(p)
    if kind in RECURRENT:
        return RECURRENT[kind][0](p, h, cfg, state=cache)
    a_out, cache["k"], cache["v"] = decode_self_attention(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), cfg, kind,
        cache["k"], cache["v"], pos)
    h = h + a_out
    if "xk" in cache:
        h = h + decode_cross_attention(p["xattn"], rms_norm(h, p["ln_x"], cfg.norm_eps),
                                       cache["xk"], cache["xv"], cfg)
    f_out, _ = _ffn_out(cfg, p, rms_norm(h, p["ln2"], cfg.norm_eps))
    return h + f_out, cache


# ---------------------------------------------------------------------------
# Functional passes over a flat param dict
# ---------------------------------------------------------------------------
def embed_tokens(params: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return constrain(ops.embedding(params["embed"], tokens).to(dtype),
                     "act_batch", "act_seq", None)


def unembed(params: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    h = constrain(h, "act_batch", "act_seq", None)
    if cfg.tie_embeddings:
        return h @ gather_fsdp(params["embed"].to(h.dtype)).T
    return h @ gather_fsdp(params["lm_head"].to(h.dtype))


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BMM = torch.ops.aten.bmm.default
# products the selective policies kept in the last ``loss_fn``'s forward:
# (shape, dtype) of each, in order
SAVED: list = []


def _saved_shape(op, args) -> tuple:
    a, b = (args[1], args[2]) if op is torch.ops.aten.addmm.default else (args[0], args[1])
    return (*a.shape[:-1], b.shape[-1])


def _keep(ctx, op, args) -> CheckpointPolicy:
    if not ctx.is_recompute:
        SAVED.append((_saved_shape(op, args), args[-1].dtype))
    return CheckpointPolicy.MUST_SAVE


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``dots``, the reference's ``dots_with_no_batch_dims_saveable``: keep
    every product without batch dims (mm, addmm, and the bmm over a batch
    of 1 that a projection einsum lowers to), recompute the rest (the
    kernels, attention's batched products, the MoE experts' bmm over E)."""
    if op in _DOTS or (op is _BMM and args[0].shape[0] == 1):
        return _keep(ctx, op, args)
    return CheckpointPolicy.PREFER_RECOMPUTE


def _attn_out_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``save_attn``, the reference's ``save_only_these_names("attn_out")``:
    keep self-attention's output after ``wo`` (the product made inside
    ``layers.attn_out_site``), recompute the rest."""
    if SITES.attn_out and op in _DOTS:
        return _keep(ctx, op, args)
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _both(outer, inner):
    with outer, inner:
        yield


def _selective(policy):
    """``context_fn`` of a selective policy: its caching and cached modes,
    each inside ``recompute_contexts``'s mesh context."""
    def context_fn():
        keep, cached = create_selective_checkpoint_contexts(policy)
        fwd, again = recompute_contexts()
        return _both(fwd, keep), _both(again, cached)
    return context_fn


REMAT = {"full": recompute_contexts, "dots": _selective(_dots_policy),
         "save_attn": _selective(_attn_out_policy)}


def _remat(cfg: ArchConfig):
    """The ``context_fn`` that recomputes each layer in the backward under
    ``cfg.remat_policy`` (the reference remats each scan body, here each
    layer, through ``torch.utils.checkpoint``), or None when grad is off or
    the policy is ``"none"``.  ``"full"`` keeps only the layer's inputs;
    ``"dots"`` and ``"save_attn"`` keep what their policies name."""
    if not torch.is_grad_enabled() or cfg.remat_policy == "none":
        return None
    if cfg.remat_policy not in REMAT:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; one of "
                         f"{['none', *REMAT]}")
    return REMAT[cfg.remat_policy]


def run_groups(params: dict, cfg: ArchConfig, h: torch.Tensor, *, causal: bool = True,
               positions: Optional[torch.Tensor] = None, collect_cache: bool = False,
               enc_out: Optional[torch.Tensor] = None):
    """Apply all block groups, each attention layer cross-attending to
    ``enc_out`` when it is given. Returns (h, aux, caches|None): aux the MoE
    FFNs' ``AUX_KEYS`` summed over the layers, f32 (zeros without MoE);
    each group's cache is {"p{i}": entry}, each tensor of the layer's entry
    ({"k", "v"} and {"xk", "xv"}, {"S", "ts1", "ts2"} or {"h", "conv"})
    stacked over the group's layers. A recurrent layer's state is written
    straight into its slice of the stack."""
    caches = []
    aux = torch.zeros((len(AUX_KEYS),), dtype=torch.float32, device=h.device)
    remat = None if collect_cache else _remat(cfg)
    on_mesh = isinstance(h, DTensor)
    axes = cache_axes(cfg)["groups"] if collect_cache else None
    for g, (pattern, repeats) in enumerate(cfg.block_groups):
        cache_g, entries = {}, {}
        layers = [_layers(params, f"groups/{g}/p{i}/", repeats) for i in range(len(pattern))]
        for r in range(repeats):
            # the residual stream at the boundary of the reference's scan body
            h = constrain(h, "act_batch", "act_res_seq", None)
            for i, kind in enumerate(pattern):
                apply = functools.partial(apply_layer, cfg, kind, causal=causal,
                                          positions=positions, enc_out=enc_out)
                if not collect_cache:
                    h, a, _ = (checkpoint(apply, layers[i][r], h, use_reentrant=False,
                                          context_fn=remat) if remat
                               else apply(layers[i][r], h))
                    if a is not None:
                        aux = aux + a
                    continue
                state = None
                if kind in RECURRENT:
                    if r == 0:
                        zero = RECURRENT[kind][1](cfg, h.shape[0], h.device, stack=repeats)
                        cache_g[f"p{i}"] = {name: distribute_as(t, *axes[g][f"p{i}"][name])
                                            for name, t in zero.items()}
                    state = {name: t[r] for name, t in cache_g[f"p{i}"].items()}
                h, a, entry = apply(layers[i][r], h, state=state)
                if a is not None:
                    aux = aux + a
                if kind in RECURRENT:
                    continue
                if on_mesh:  # DTensor cannot write a slice of a plain stack: stacked below
                    entries.setdefault(f"p{i}", []).append(entry)
                    continue
                if r == 0:
                    cache_g[f"p{i}"] = {
                        name: torch.empty((repeats,) + t.shape, dtype=t.dtype, device=t.device)
                        for name, t in entry.items()}
                for name, t in entry.items():
                    cache_g[f"p{i}"][name][r] = t
        for key, ents in entries.items():
            cache_g[key] = {name: constrain(torch.stack([e[name] for e in ents]),
                                            *axes[g][key][name]) for name in ents[0]}
        caches.append(cache_g)
    return h, aux, (caches if collect_cache else None)


def run_encoder(params: dict, cfg: ArchConfig, frames: torch.Tensor, *,
                dtype: torch.dtype) -> torch.Tensor:
    """The bidirectional encoder over stubbed frame embeddings (B, Se, d):
    ``n_enc_layers`` global layers without a mask, remat as the decoder's,
    then the encoder's final norm.  An MoE FFN's aux is discarded, as the
    reference discards it."""
    h = frames.to(dtype)
    positions = torch.arange(h.shape[1], device=h.device)
    apply = functools.partial(apply_layer, cfg, "global", causal=False, positions=positions)
    remat = _remat(cfg)
    h = constrain(h, "act_batch", "act_seq", None)
    for p in _layers(params, "encoder/blocks/", cfg.n_enc_layers):
        h = constrain(h, "act_batch", "act_res_seq", None)
        h, _, _ = (checkpoint(apply, p, h, use_reentrant=False, context_fn=remat)
                   if remat else apply(p, h))
    return rms_norm(h, params["encoder/ln_f"], cfg.norm_eps)


def forward(params: dict, cfg: ArchConfig, batch: dict, *, dtype: torch.dtype,
            collect_cache: bool = False):
    """batch: tokens (B, S) [+ frames (B, Se, d) for an encoder-decoder |
    patches (B, P, d), put in front of the tokens].  Returns (final-normed
    h in ``dtype`` over the joined length, aux, caches|None)."""
    h = embed_tokens(params, batch["tokens"], dtype)
    enc_out = run_encoder(params, cfg, batch["frames"], dtype=dtype) if cfg.enc_dec else None
    if cfg.n_patches and "patches" in batch:
        h = torch.cat([batch["patches"].to(h.dtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)
    h, aux, caches = run_groups(params, cfg, h, causal=True, positions=positions,
                                collect_cache=collect_cache, enc_out=enc_out)
    return rms_norm(h, params["ln_f"], cfg.norm_eps), aux, caches


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
        run = (lambda *a: checkpoint(ce, *a, use_reentrant=False,
                                     context_fn=recompute_contexts)) \
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


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *,
            dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """Scalar training loss and metrics; batch["tokens"] is (B, S + 1),
    shifted into inputs and labels; batch["mask"] (B, S) is optional, and
    the frontend stubs ("frames", "patches") go to ``forward`` as they are.
    Patch positions predict no token.  With an MoE FFN the loss adds (load
    balance + router z) / the attention layers' count, and the metrics
    carry the three aux means over them."""
    check_supported(cfg)
    SAVED.clear()
    params = cast_params(params, dtype)
    tokens = batch["tokens"]
    labels = tokens[:, 1:]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    h, aux, _ = forward(params, cfg, dict(batch, tokens=tokens[:, :-1]), dtype=dtype)
    if cfg.n_patches and "patches" in batch:
        h = h[:, cfg.n_patches:]  # only text positions predict tokens
    loss, metrics = lm_loss(params, cfg, h, labels, mask)
    if cfg.moe is not None:
        n = float(max(cfg.count_kind(*ATTN_KINDS), 1))
        lb, zl, dropped = aux.unbind()
        loss = loss + (lb + zl) / n
        metrics.update(moe_lb_loss=lb / n, moe_z_loss=zl / n, moe_dropped=dropped / n)
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Decode-cache template and its logical axes (the layout the prefill returns)
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, seq_len: int, enc_len: int = 0, *,
               dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cpu") -> dict:
    """A zero decode cache for ``seq_len`` positions, as the reference's:
    {"pos": int32 scalar, "groups": [{"p{i}": entry}]}, each tensor stacked
    over its group's layers; an attention entry {"k", "v"} (B, L, KV, Dh)
    in ``dtype`` (and {"xk", "xv"} over ``enc_len`` encoder frames, or
    ``seq_len``, for an encoder-decoder), a recurrent one the f32 state.
    Any device, ``meta`` too."""
    check_supported(cfg)
    kv = (cfg.n_kv_heads, cfg.d_head)
    groups = []
    for pattern, repeats in cfg.block_groups:
        g = {}
        for i, kind in enumerate(pattern):
            if kind in RECURRENT:
                g[f"p{i}"] = RECURRENT[kind][1](cfg, batch, device, stack=repeats)
                continue
            shapes = {"k": (batch, cfg.kv_cache_len(kind, seq_len)) + kv}
            shapes["v"] = shapes["k"]
            if cfg.enc_dec:
                shapes["xk"] = shapes["xv"] = (batch, enc_len or seq_len) + kv
            g[f"p{i}"] = {name: torch.zeros((repeats,) + shape, dtype=dtype, device=device)
                          for name, shape in shapes.items()}
        groups.append(g)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device), "groups": groups}


def cache_axes(cfg: ArchConfig) -> dict:
    """Logical axes of ``init_cache``'s tensors, tree for tree (the
    reference's ``cache_axes``)."""
    kv = ("layers", "cache_batch", "cache_seq", "act_kv_heads", None)
    state_axes = {"rwkv": recurrent.rwkv_state_axes, "rglru": recurrent.rglru_state_axes}
    groups = []
    for pattern, _ in cfg.block_groups:
        g = {}
        for i, kind in enumerate(pattern):
            if kind in state_axes:
                g[f"p{i}"] = {k: ("layers",) + v for k, v in state_axes[kind](cfg).items()}
            else:
                g[f"p{i}"] = {"k": kv, "v": kv}
                if cfg.enc_dec:
                    g[f"p{i}"].update(xk=kv, xv=kv)
        groups.append(g)
    return {"pos": (), "groups": groups}


def decode_groups(params: dict, cfg: ArchConfig, h: torch.Tensor, cache_groups: list,
                  pos: int) -> torch.Tensor:
    """One token through every layer, each layer's slice of ``cache_groups``
    updated in place."""
    for g, ((pattern, repeats), gcache) in enumerate(zip(cfg.block_groups, cache_groups)):
        layers = [_layers(params, f"groups/{g}/p{i}/", repeats) for i in range(len(pattern))]
        for r in range(repeats):
            for i, kind in enumerate(pattern):
                layer_cache = {name: t[r] for name, t in gcache[f"p{i}"].items()}
                h, _ = decode_apply_layer(cfg, kind, layers[i][r], h, layer_cache, pos)
    return h


def prefill(params: dict, cfg: ArchConfig, batch: dict, *, dtype: torch.dtype):
    """batch as :func:`forward` takes it -> (next-token logits (B, 1, V),
    cache {"pos": the joined length, "groups"}).  On a mesh (inside
    ``mesh_context``, DTensor params and batch) the cache's tensors are
    placed by :func:`cache_axes`."""
    with plain_as_replicated():
        h, _, caches = forward(params, cfg, batch, dtype=dtype, collect_cache=True)
        return unembed(params, cfg, h[:, -1:]), {"pos": h.shape[1], "groups": caches}


def decode(params: dict, cfg: ArchConfig, cache: dict, tokens: torch.Tensor, *,
           dtype: torch.dtype):
    """One decode step. tokens (B, 1) -> (logits, cache); the cache's
    tensors are updated in place.  ``cache["pos"]`` is an int or an integer
    scalar tensor (``init_cache``'s)."""
    pos = int(cache["pos"])
    with plain_as_replicated():
        h = embed_tokens(params, tokens, dtype)
        h = decode_groups(params, cfg, h, cache["groups"], pos)
        h = rms_norm(h, params["ln_f"], cfg.norm_eps)
        return unembed(params, cfg, h), {"pos": pos + 1, "groups": cache["groups"]}


class Transformer(nn.Module):
    """The model (global, local or chunked attention with a dense or MoE
    FFN, RWKV-6 and RG-LRU layers; an encoder and cross-attention for an
    encoder-decoder config) with stacked per-group weights, for serving.

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

    def forward(self, batch: dict, *, collect_cache: bool = False):
        """batch as :func:`forward` takes it -> (final-normed h, caches|None);
        serving drops the MoE aux."""
        h, _, caches = forward(self.flat, self.cfg, batch, dtype=self.dtype,
                               collect_cache=collect_cache)
        return h, caches

    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """:func:`decode` over the module's weights."""
        return decode(self.flat, self.cfg, cache, tokens, dtype=self.dtype)
