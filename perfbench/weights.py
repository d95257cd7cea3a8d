"""The inputs a cell hands to the program and to the reference alike: the
master weights and the pool of token batches, both made from ``--seed``.

Leaves are named and shaped as the port's ``model_defs`` names them
(``groups/0/p0/attn/wq``, each block group's layers stacked on a leading
axis), worked out here from the configuration file alone, so that the
reference needs nothing of the program.  Each leaf is drawn by one call on
the device from a generator seeded by (seed, leaf name), so any leaf can be
drawn again by itself: the change of the parameters over the checked steps
is taken against the initial leaf drawn anew, not against a kept copy.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import torch


SKETCHES = 8               # random directions a sketch takes
SKETCH_CHUNK = 1 << 24     # elements drawn at a time


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    init: str           # "normal" | "ones"
    std: float = 0.0    # of a normal leaf


def _normal(name: str, shape: tuple, scale: float = 1.0) -> Leaf:
    # fan-in over the stacked shape, as the port's params.normal_init takes it
    fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
    return Leaf(name, tuple(shape), "normal", scale / math.sqrt(max(fan_in, 1)))


def leaves(cfg: dict) -> list[Leaf]:
    """Every master weight of the configuration, sorted by name."""
    d, V, L = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    H, KV, Dh, f = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"], cfg["d_ff"]
    pre = "groups/0/p0/"
    out = [
        _normal("embed", (V, d)),
        Leaf("ln_f", (d,), "ones"),
        Leaf(pre + "ln1", (L, d), "ones"),
        Leaf(pre + "ln2", (L, d), "ones"),
        _normal(pre + "attn/wq", (L, d, H, Dh)),
        _normal(pre + "attn/wk", (L, d, KV, Dh)),
        _normal(pre + "attn/wv", (L, d, KV, Dh)),
        _normal(pre + "attn/wo", (L, H, Dh, d)),
    ]
    if not cfg["tie_embeddings"]:
        out.append(_normal("lm_head", (d, V)))
    moe = cfg.get("moe")
    if moe:
        E = moe["n_experts"]
        out += [_normal(pre + "moe/router", (L, d, E), 0.1),
                _normal(pre + "moe/w_gate", (L, E, d, f)),
                _normal(pre + "moe/w_up", (L, E, d, f)),
                _normal(pre + "moe/w_down", (L, E, f, d))]
    else:
        out += [_normal(pre + "ffn/w_up", (L, d, f)), _normal(pre + "ffn/w_down", (L, f, d))]
        if cfg["ffn_gated"]:
            out.append(_normal(pre + "ffn/w_gate", (L, d, f)))
    return sorted(out, key=lambda leaf: leaf.name)


def _seed_of(seed: int, *parts) -> int:
    text = "/".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def draw(leaf: Leaf, seed: int, device: torch.device) -> torch.Tensor:
    """One leaf's initial f32 value on ``device``."""
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed_of(seed, "weights", leaf.name))
    out = torch.randn(leaf.shape, generator=gen, dtype=torch.float32, device=device)
    return out.mul_(leaf.std)


def draw_all(cfg: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    return {leaf.name: draw(leaf, seed, device) for leaf in leaves(cfg)}


@torch.no_grad()
def sketch(x: torch.Tensor, seed: int, tag: str, name: str) -> list[float]:
    """``x``'s dot products with SKETCHES directions of
    independent standard normal entries, drawn on ``x``'s device from
    (seed, tag, name) in chunks of SKETCH_CHUNK elements, so both sides of
    the comparison draw the same directions.  For any d, the mean square of
    <d, r> over the directions estimates |d|^2: the gap between two sides'
    sketches is a direction-sensitive reading of the gap between the two
    tensors themselves, taken without keeping either."""
    flat = x.detach().reshape(-1)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(_seed_of(seed, "sketch", tag, name))
    acc = torch.zeros(SKETCHES, dtype=torch.float64, device=x.device)
    for j in range(SKETCHES):
        for c0 in range(0, flat.numel(), SKETCH_CHUNK):
            part = flat[c0:c0 + SKETCH_CHUNK]
            r = torch.randn(part.numel(), generator=gen, dtype=torch.float32, device=x.device)
            # in x's own type (f32 leaves): its rounding is far under the gaps read
            acc[j] += torch.dot(part, r.to(part.dtype))
    return acc.tolist()


def token_pool(vocab: int, n_batches: int, batch: int, seq_len: int, seed: int) -> torch.Tensor:
    """(n_batches, batch, seq_len + 1) int32 token ids on the host, uniform
    over the vocabulary; every seed gives the same sizes."""
    gen = torch.Generator()
    gen.manual_seed(_seed_of(seed, "tokens"))
    return torch.randint(vocab, (n_batches, batch, seq_len + 1), generator=gen,
                         dtype=torch.int64).to(torch.int32)
