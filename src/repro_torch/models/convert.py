"""Carry weights across from the reference package.

The input is the reference's checkpoint form: a flat dict keyed by flatten
path (``groups/0/p0/attn/wq``) of numpy arrays, with bf16 either as float32
values or as uint16 bit patterns (the rule of the reference's checkpoint
encoder).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Transformer


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:  # bf16 bit patterns
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_params(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {path: _tensor(np.asarray(a)) for path, a in flat.items()}


def load_into(model: Transformer, flat: dict[str, np.ndarray]) -> Transformer:
    """Copy reference weights into ``model`` (cast to its dtype), strictly:
    a missing or extra path raises."""
    model.load_state_dict(from_jax_params(flat), strict=True)
    return model
