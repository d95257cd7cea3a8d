"""Train, eval, prefill and decode step functions (after
``repro.models.steps``).

The train step is functional, as the reference's: (params, opt_state,
batch) -> (params, opt_state, metrics), params a flat dict of master
weights keyed by flatten path.  On a mesh (inside
``parallel.axes.mesh_context``) the params are DTensors placed by
``runtime.elastic.reshard_for`` and the batch is sharded over
``act_batch``; plain tensors made inside the model and the optimizer (RoPE
tables, masks, schedule scalars) count as replicated.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.parallel.axes import constrain, plain_as_replicated


def loss_and_grads(cfg: ArchConfig, params: dict, batch: dict, *, n_microbatches: int = 1,
                   dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of ``loss_fn`` at ``params``, computing in
    ``dtype``; the gradients are keyed as ``params``.

    ``n_microbatches > 1`` accumulates the gradients in f32 over sequential
    slices of the batch (every entry, frames and patches too, split along
    its first axis) and divides by n; the loss is the mean of the slices'
    losses.
    """
    with plain_as_replicated():
        return _loss_and_grads(cfg, params, batch, n_microbatches, dtype)


def _loss_and_grads(cfg: ArchConfig, params: dict, batch: dict, n_microbatches: int,
                    dtype: torch.dtype) -> tuple[torch.Tensor, dict, dict]:
    def one(batch: dict):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss, metrics = transformer.loss_fn(leaves, cfg, batch, dtype=dtype)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, dict(zip(leaves, grads))

    if n_microbatches <= 1:
        return one(batch)
    n = n_microbatches
    if any(x.shape[0] % n for x in batch.values()):
        raise ValueError(f"a batch of {len(batch['tokens'])} does not split into "
                         f"{n} microbatches")
    micro = [{k: _microbatch(x, n, i) for k, x in batch.items()} for i in range(n)]
    # zeros_like: on a mesh each accumulator is placed as its parameter
    grads = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    lsum = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
    for mb in micro:
        loss, _, g = one(mb)
        grads = {k: a + g[k].to(a.dtype) for k, a in grads.items()}
        lsum = lsum + loss
    loss = lsum / n
    return loss, {"loss": loss, "ce_loss": loss}, {k: g / n for k, g in grads.items()}


def _microbatch(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Rows i * B / n .. (i + 1) * B / n of ``x``.  A batch-sharded DTensor
    is gathered first (DTensor cannot split a sharded dim into (n, B / n))
    and the slice placed over ``act_batch`` again."""
    if not isinstance(x, DTensor):
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
    whole = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    part = whole.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
    return constrain(part, "act_batch", *([None] * (x.ndim - 1)))


def make_train_step(cfg: ArchConfig, opt: adamw.AdamWConfig,
                    grad_compression: Optional[str] = None, n_microbatches: int = 1, *,
                    dtype: torch.dtype = torch.bfloat16, donate: bool = False) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradients of :func:`loss_and_grads` (``n_microbatches`` as there), then
    the optimizer.  ``REPRO_OPT8BIT=1``, read when the step is made, takes
    the 8-bit optimizer state (``adamw.init_8bit``; the step's ``opt8bit``
    says which state it takes).  ``donate=True`` updates the params and
    moments in place (``adamw.apply``'s and ``apply_8bit``'s ``donate``):
    the caller gives up the ones it passed, and the step holds one copy of
    them.
    """
    use_8bit = os.environ.get("REPRO_OPT8BIT") == "1"
    apply = adamw.apply_8bit if use_8bit else adamw.apply

    def apply_fn(*args):
        return apply(*args, donate=donate)

    def train_step(params: dict, opt_state: adamw.AdamWState, batch: dict):
        _, metrics, grads = loss_and_grads(cfg, params, batch,
                                           n_microbatches=n_microbatches, dtype=dtype)
        if grad_compression:
            grads = compression.compress_tree(grads, method=grad_compression)
        with plain_as_replicated():
            params, opt_state, opt_metrics = apply_fn(opt, params, opt_state, grads)
        return params, opt_state, dict(metrics, **opt_metrics)

    train_step.opt8bit = use_8bit
    return train_step


def make_eval_step(cfg: ArchConfig, *, dtype: torch.dtype = torch.bfloat16) -> Callable:
    """(params, batch) -> metrics of ``loss_fn``, without gradients."""

    @torch.no_grad()
    def eval_step(params: dict, batch: dict):
        _, metrics = transformer.loss_fn(params, cfg, batch, dtype=dtype)
        return metrics

    return eval_step


def make_prefill_step(model: Transformer) -> Callable:
    """batch (tokens, and frames or patches as ``transformer.forward`` takes
    them) -> (next_token_logits (B, 1, V), cache {"pos", "groups"}); "pos"
    is the joined length, patches included."""

    @torch.inference_mode()
    def prefill_step(batch: dict):
        return transformer.prefill(model.flat, model.cfg, batch, dtype=model.dtype)

    return prefill_step


def make_decode_step(model: Transformer) -> Callable:
    """(cache, tokens (B, 1)) -> (logits, new_cache)."""

    @torch.inference_mode()
    def decode_step(cache: dict, tokens: torch.Tensor):
        return model.decode_step(cache, tokens)

    return decode_step


def make_serve_steps(cfg: ArchConfig, *, dtype: torch.dtype = torch.bfloat16
                     ) -> tuple[Callable, Callable]:
    """The reference's functional serving steps: (params, batch) -> (logits,
    cache) and (params, cache, tokens) -> (logits, cache), params a flat
    dict in ``dtype``.  On a mesh (inside ``parallel.axes.mesh_context``
    with ``SERVE_RULES``, or ``LONG_CONTEXT_RULES`` at batch 1) the params
    are DTensors placed by ``params.shardings``, the batch is sharded over
    ``act_batch`` and the cache is placed by ``transformer.cache_axes``."""

    @torch.no_grad()
    def prefill_step(params: dict, batch: dict):
        return transformer.prefill(params, cfg, batch, dtype=dtype)

    @torch.no_grad()
    def decode_step(params: dict, cache: dict, tokens: torch.Tensor):
        return transformer.decode(params, cfg, cache, tokens, dtype=dtype)

    return prefill_step, decode_step
