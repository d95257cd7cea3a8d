"""Prefill and decode step functions (after ``repro.models.steps``)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.transformer import Transformer


def make_prefill_step(model: Transformer) -> Callable:
    """batch -> (next_token_logits (B, 1, V), cache {"pos", "groups"})."""

    @torch.inference_mode()
    def prefill_step(batch: dict):
        h, caches = model(batch["tokens"], collect_cache=True)
        logits = model.unembed(h[:, -1:])
        return logits, {"pos": h.shape[1], "groups": caches}

    return prefill_step


def make_decode_step(model: Transformer) -> Callable:
    """(cache, tokens (B, 1)) -> (logits, new_cache)."""

    @torch.inference_mode()
    def decode_step(cache: dict, tokens: torch.Tensor):
        return model.decode_step(cache, tokens)

    return decode_step
