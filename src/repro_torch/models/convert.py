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


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A tensor of the array's values; uint16 is read as bf16 bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:  # bf16 bit patterns
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """The tensor's values on the host; bf16 as uint16 bit patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_jax_params(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {path: tensor_from_numpy(np.asarray(a)) for path, a in flat.items()}


def load_into(model: Transformer, flat: dict[str, np.ndarray]) -> Transformer:
    """Copy reference weights into ``model`` (cast to its dtype), strictly:
    a missing or extra path raises."""
    model.load_state_dict(from_jax_params(flat), strict=True)
    return model
