"""Plain PyTorch reference of a training cell: the model's loss and
gradients and the AdamW update, in float32, written from the configuration
file alone (it imports nothing of the program and calls none of its
kernels).

It runs after the program's state is freed, so it has the card to itself,
and it computes in blocks so that it fits beside its own state (params,
gradients and both moments, 16 bytes a parameter): one block of batch rows
at a time (whole MoE groups; the gradients accumulate in ``.grad``),
attention by blocks of query rows recomputed in the backward, and the
cross entropy by chunks of positions.

The MoE layer is written in the dense one-hot form (dispatch and combine as
products with one-hot tensors, as t5x writes it), not as the port's
gathers.  Its semantics are the configuration's: groups of the largest
divisor of the batch's tokens not above ``group_size``, each token's top-k
experts by router probability (ties to the lower expert), gates
renormalised over the k, an expert's slots taken in (token, k) order up to
its capacity, later slots dropped.

Which experts a token takes is a discrete choice, and with random weights
many tokens have near-ties that bf16 and f32 break differently; with
capacity drops each such flip moves the slots of the tokens after it.  So
the reference follows the routes it is given (the program's, recorded in
its checked steps) and judges each: a route's gap is how far the chosen
experts' reference probabilities lie below the reference's own k-th best,
0 for a route the reference would take itself.  The largest gap is the
number compared, as a served token's gap below the reference's best logit
would be.

``FP8`` is the control: the same reference with every product of the model
(projections, attention, experts, the head; the router stays f32) taken on
operands rounded to float8 (e4m3 forward, e5m2 for the gradients, one
power-of-two scale a tensor), the step below the bfloat16 compute the
configurations state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import weights

ATTN_BLOCK = 512       # query rows of one attention block
Z_LOSS = 1e-4          # the cross entropy's z-loss coefficient


class Float32:
    name = "float32"

    @staticmethod
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(a, b)


def qdq(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one power-of-two scale that puts its
    largest magnitude at the top of the type's range."""
    amax = x.abs().amax().float()
    fmax = torch.finfo(dtype).max
    scale = torch.where(amax > 0, torch.exp2(torch.floor(torch.log2(fmax / amax))),
                        torch.ones_like(amax))
    return (x * scale).to(dtype).to(x.dtype) / scale


def _mm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # float8 values are exact in bfloat16: the products are exact and summed
    # in f32, the result rounded to bfloat16 as a float8 GEMM writes it
    return torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)).float()


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = qdq(a, torch.float8_e4m3fn), qdq(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return _mm_exact(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = qdq(g, torch.float8_e5m2)
        return _mm_exact(qg, qb.transpose(-1, -2)), _mm_exact(qa.transpose(-1, -2), qg)


class FP8:
    name = "fp8"

    @staticmethod
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.dim() != b.dim():
            raise ValueError(f"fp8 products take operands of equal rank, not {a.dim()} and {b.dim()}")
        return _Fp8MatMul.apply(a, b)


PRECISIONS = {"float32": Float32, "fp8": FP8}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(S: int, D: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (S, 1, D/2) of the split-halves rotation, angles in f64."""
    half = D // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * freqs
    return torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]


def rope(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_block(q, k, v, p0: int, k0: int, window: int, prec):
    """Causal softmax attention of the query rows at positions p0.. (q (n,
    H, D)) over the keys at positions k0.. (k, v (m, KV, D)); query head h
    reads KV head h // (H / KV)."""
    n, H, D = q.shape
    m, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(n, KV, G, D).permute(1, 2, 0, 3).reshape(KV, G * n, D)
    s = prec.mm(qg, k.permute(1, 2, 0)).view(KV, G, n, m) / math.sqrt(D)
    pos = p0 + torch.arange(n, device=q.device)[:, None]
    key = k0 + torch.arange(m, device=q.device)[None, :]
    ok = key <= pos
    if window:
        ok = ok & (pos - key < window)
    pr = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    o = prec.mm(pr.view(KV, G * n, m), v.permute(1, 0, 2))
    return o.view(KV, G, n, D).permute(2, 0, 1, 3).reshape(n, H, D)


def attention(q, k, v, window: int, prec):
    """One sequence (S, H, D) by blocks of ATTN_BLOCK query rows, each
    recomputed in the backward; a block reads only the keys its mask
    keeps."""
    S = q.shape[0]
    out = []
    for p0 in range(0, S, ATTN_BLOCK):
        p1 = min(S, p0 + ATTN_BLOCK)
        k0 = max(0, p0 - window + 1) if window else 0
        out.append(checkpoint(_attn_block, q[p0:p1], k[k0:p1], v[k0:p1], p0, k0, window, prec,
                              use_reentrant=False))
    return torch.cat(out)


def group_size(cfg: dict, tokens: int) -> int:
    """The largest divisor of ``tokens`` not above the MoE group size."""
    G = min(cfg["moe"]["group_size"], tokens)
    while tokens % G:
        G -= 1
    return G


def capacity(cfg: dict, G: int) -> int:
    """An expert's slots in a group of G tokens: a multiple of 4, at least 4."""
    spec = cfg["moe"]
    c = math.ceil(G * spec["top_k"] * spec["capacity_factor"] / spec["n_experts"])
    return max(4, math.ceil(c / 4) * 4)


def moe(p: dict, x: torch.Tensor, cfg: dict, prec, G: int, route=None):
    """(out (T, d), the load-balance loss summed over the groups, the router
    z-loss summed over the tokens, and the routing's record) of T tokens in
    whole groups of G.  ``route`` (groups, G, k), when given, is followed
    in place of the reference's own choice."""
    spec = cfg["moe"]
    E, K = spec["n_experts"], spec["top_k"]
    T, d = x.shape
    ng = T // G
    C = capacity(cfg, G)
    logits = (x @ p["moe/router"]).view(ng, G, E)
    probs = torch.softmax(logits, dim=-1)
    ranked = torch.sort(probs.detach(), dim=-1, descending=True, stable=True)
    own = ranked.indices[..., :K]
    idx, gap, flips = own, 0.0, 0
    if route is not None:
        idx = route.to(x.device)
        taken = probs.detach().gather(-1, idx).min(-1).values
        gap = float((ranked.values[..., K - 1] - taken).clamp(min=0).max())
        flips = int((own.sort(-1).values != idx.sort(-1).values).any(-1).sum())
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    chosen = F.one_hot(idx, E)                                        # (ng, G, K, E) int64
    place = chosen.view(ng, G * K, E).cumsum(1).view(ng, G, K, E)
    place = (place * chosen).sum(-1) - 1                              # (ng, G, K)
    keep = place < C
    onehot = chosen.float()
    slot = F.one_hot(place.clamp(max=C - 1), C).float() * keep[..., None]
    dispatch = torch.einsum("sgke,sgkc->sgec", onehot, slot)
    combine = torch.einsum("sgke,sgkc,sgk->sgec", onehot, slot, gates)
    xin = torch.einsum("sgec,sgd->escd", dispatch, x.view(ng, G, d)).reshape(E, ng * C, d)
    h = F.silu(prec.mm(xin, p["moe/w_gate"])) * prec.mm(xin, p["moe/w_up"])
    eo = prec.mm(h, p["moe/w_down"]).view(E, ng, C, d)
    out = torch.einsum("sgec,escd->sgd", combine, eo).reshape(T, d)
    me = probs.mean(dim=1)
    ce = onehot.sum(2).mean(dim=1)
    lb = (me * ce).sum() * E * spec["load_balance_loss"]
    z = torch.logsumexp(logits, dim=-1).pow(2).sum() * spec["router_z_loss"]
    record = {"route": idx.cpu(), "gap": gap, "flips": flips, "dropped": int((~keep).sum())}
    return out, lb, z, record


def ffn(p: dict, x: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    u = prec.mm(x, p["ffn/w_up"])
    if cfg["ffn_gated"]:
        a = F.silu(prec.mm(x, p["ffn/w_gate"])) * u
    else:
        a = F.gelu(u, approximate="tanh")
    return prec.mm(a, p["ffn/w_down"])


def layer(p: dict, h: torch.Tensor, cfg: dict, prec, rows: int, rot, G: int, route=None):
    """One pre-norm block over ``rows`` sequences (h (rows * S, d)): (h, the
    MoE's load-balance and z sums, its routing record or None)."""
    T, d = h.shape
    S = T // rows
    H, KV, Dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    window = cfg["window"] if cfg["layer_kind"] == "local" else 0
    x = rms_norm(h, p["ln1"], cfg["norm_eps"])
    q = prec.mm(x, p["attn/wq"].reshape(d, H * Dh)).view(rows, S, H, Dh)
    k = prec.mm(x, p["attn/wk"].reshape(d, KV * Dh)).view(rows, S, KV, Dh)
    v = prec.mm(x, p["attn/wv"].reshape(d, KV * Dh)).view(rows, S, KV, Dh)
    q, k = rope(q, *rot), rope(k, *rot)
    o = torch.stack([attention(q[r], k[r], v[r], window, prec) for r in range(rows)])
    h = h + prec.mm(o.reshape(T, H * Dh), p["attn/wo"].reshape(H * Dh, d))
    x = rms_norm(h, p["ln2"], cfg["norm_eps"])
    if cfg.get("moe"):
        f, lb, z, record = moe(p, x, cfg, prec, G, route)
        return h + f, lb, z, record
    return h + ffn(p, x, cfg, prec), 0.0, 0.0, None


def _ce_chunk(hc, labels, head, prec):
    logits = prec.mm(hc, head)
    logz = torch.logsumexp(logits, dim=-1)
    nll = (logz - logits.gather(1, labels[:, None])[:, 0]).sum()
    return torch.stack([nll, Z_LOSS * logz.pow(2).sum()])


def _layer_views(P: dict, L: int) -> list[dict]:
    """Each layer's slice of the stacked leaves (one ``unbind`` a leaf, so a
    leaf gets one stacked gradient)."""
    out = [{} for _ in range(L)]
    pre = "groups/0/p0/"
    for name, t in P.items():
        if name.startswith(pre):
            for layer_p, view in zip(out, t.unbind(0)):
                layer_p[name[len(pre):]] = view
    return out


def loss_and_backward(P: dict, cfg: dict, tokens: torch.Tensor, prec, *,
                      n_microbatches: int = 1, routes=None) -> tuple[float, dict]:
    """The step's loss (a Python float) over tokens (B, S + 1) on the
    device; the gradients accumulate into each leaf's ``.grad``.  MoE
    groups are those of a microbatch's tokens, as the step makes them.
    ``routes``, one (groups, G, k) a layer, are followed; the record has
    the routes taken, their largest gap, the tokens whose experts differ
    from the reference's own choice, and the slots dropped."""
    B, S = tokens.shape[0], tokens.shape[1] - 1
    L = cfg["n_layers"]
    moe_cfg = cfg.get("moe")
    G = group_size(cfg, B * S // n_microbatches) if moe_cfg else 0
    R = G // math.gcd(S, G) if moe_cfg else 1
    if B % R:
        raise ValueError(f"MoE groups of {G} do not fall in blocks of whole rows of {S}")
    n_groups = B * S // G if G else 1
    rot = rope_tables(S, cfg["d_head"], cfg["rope_theta"], tokens.device)
    chunk = cfg["loss_chunk"] if cfg["loss_chunk"] and S % cfg["loss_chunk"] == 0 else S
    total = 0.0
    records = [[] for _ in range(L)]
    for r0 in range(0, B, R):
        blk = tokens[r0:r0 + R].long()
        inputs, labels = blk[:, :-1].reshape(-1), blk[:, 1:].reshape(-1)
        h = P["embed"][inputs]
        g0, g1 = r0 * S // G if G else 0, (r0 + R) * S // G if G else 0
        lb = z = 0.0
        for i, p in enumerate(_layer_views(P, L)):
            route = routes[i][g0:g1] if routes is not None else None
            h, lb_l, z_l, record = layer(p, h, cfg, prec, R, rot, G, route)
            lb, z = lb + lb_l, z + z_l
            if record is not None:
                records[i].append(record)
        h = rms_norm(h, P["ln_f"], cfg["norm_eps"])
        head = P["embed"].T if cfg["tie_embeddings"] else P["lm_head"]
        nll = zl = 0.0
        for c0 in range(0, R * S, chunk):
            part = checkpoint(_ce_chunk, h[c0:c0 + chunk], labels[c0:c0 + chunk], head, prec,
                              use_reentrant=False)
            nll, zl = nll + part[0], zl + part[1]
        loss = (nll + zl) / (B * S)
        if moe_cfg:
            loss = loss + (lb / n_groups + z / (B * S)) / L
        loss.backward()
        total += float(loss.detach())
        del h, loss
    flat = [r for layer_records in records for r in layer_records]
    return total, {
        "routes": [torch.cat([r["route"] for r in layer_records]) for layer_records in records]
        if moe_cfg else None,
        "route_gap": max((r["gap"] for r in flat), default=0.0),
        "flips": sum(r["flips"] for r in flat),
        "dropped": sum(r["dropped"] for r in flat)}


def lr_at(hp: dict, t: int) -> float:
    """Linear warmup, then cosine decay to ``min_lr_ratio``."""
    warm = min(t / max(hp["warmup_steps"], 1), 1.0)
    prog = min(max((t - hp["warmup_steps"]) / max(hp["total_steps"] - hp["warmup_steps"], 1),
                   0.0), 1.0)
    decay = hp["min_lr_ratio"] + (1.0 - hp["min_lr_ratio"]) * 0.5 * (1.0 + math.cos(math.pi * prog))
    return hp["lr"] * warm * decay


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


@torch.no_grad()
def adamw(P: dict, m: dict, v: dict, t: int, hp: dict, sketch_seed=None) -> tuple[dict, dict]:
    """One AdamW step at step number t (from 1) on the gradients in
    ``.grad``, clipped to a global norm of ``grad_clip``; weight decay on
    every leaf.  Returns each leaf's clipped gradient norm and, where
    ``sketch_seed`` is given, its sketch (``weights.sketch``)."""
    gnorm = math.sqrt(sum(norm(p.grad) ** 2 for p in P.values()))
    scale = min(1.0, hp["grad_clip"] / max(gnorm, 1e-9))
    lr = lr_at(hp, t)
    b1, b2 = hp["b1"], hp["b2"]
    b1c, b2c = 1.0 - b1 ** t, 1.0 - b2 ** t
    norms, sketches = {}, {}
    for name, p in P.items():
        g = p.grad.mul_(scale)
        norms[name] = norm(g)
        if sketch_seed is not None:
            sketches[name] = weights.sketch(g, sketch_seed, "grad", name)
        m[name].mul_(b1).add_(g, alpha=1.0 - b1)
        v[name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        upd = (m[name] / b1c).div_((v[name] / b2c).sqrt_().add_(hp["eps"]))
        upd.add_(p, alpha=hp["weight_decay"])
        p.sub_(upd, alpha=lr)
        p.grad = None
        del g, upd
    return norms, sketches


def route_shapes(cfg: dict, batch: int, seq: int, n_microbatches: int = 1) -> tuple:
    """The shape of one layer's routes over a step: (groups, G, k)."""
    G = group_size(cfg, batch * seq // n_microbatches)
    return (batch * seq // G, G, cfg["moe"]["top_k"])


def run(cfg: dict, seed: int, batches: torch.Tensor, device, precision: str = "float32", *,
        n_microbatches: int = 1, routes=None) -> dict:
    """The reference's readings over the first ``len(batches)`` steps from
    the seed's weights: each step's loss, each leaf's clipped gradient norm
    and sketch at step 1, and the norm and sketch of each leaf's change
    from its initial value after the last step.  ``batches`` (n, B, S + 1) on the host.  An MoE
    configuration's readings add the routes taken (one list of layers a
    step) and, where ``routes`` (the same form) are given and followed,
    their largest gap; routes of another shape than the steps' are not
    followed and read an infinite gap."""
    prec = PRECISIONS[precision]
    n, B, S = batches.shape[0], batches.shape[1], batches.shape[2] - 1
    route_gap = 0.0
    if routes is not None:
        want = route_shapes(cfg, B, S, n_microbatches)
        if len(routes) != n or any(len(step) != cfg["n_layers"]
                                   or any(tuple(r.shape) != want for r in step)
                                   for step in routes):
            routes, route_gap = None, math.inf
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        P = {name: t.requires_grad_() for name, t in weights.draw_all(cfg, seed, device).items()}
        m = {name: torch.zeros_like(t) for name, t in P.items()}
        v = {name: torch.zeros_like(t) for name, t in P.items()}
        losses, grad_norm, taken, flips, dropped = [], {}, [], [], []
        for t, batch in enumerate(batches, start=1):
            loss, record = loss_and_backward(
                P, cfg, batch.to(device), prec, n_microbatches=n_microbatches,
                routes=routes[t - 1] if routes is not None else None)
            norms, sketches = adamw(P, m, v, t, cfg["optimizer"], seed if t == 1 else None)
            losses.append(loss)
            taken.append(record["routes"])
            route_gap = max(route_gap, record["route_gap"])
            flips.append(record["flips"])
            dropped.append(record["dropped"])
            if t == 1:
                grad_norm, grad_sketch = norms, sketches
        del m, v
        change, change_sketch = {}, {}
        with torch.no_grad():
            for leaf in weights.leaves(cfg):
                delta = P[leaf.name] - weights.draw(leaf, seed, device)
                change[leaf.name] = norm(delta)
                change_sketch[leaf.name] = weights.sketch(delta, seed, "update", leaf.name)
                del delta
        out = {"loss": losses, "grad_norm": grad_norm, "update_norm": change,
               "grad_sketch": grad_sketch, "update_sketch": change_sketch}
        if cfg.get("moe"):
            out.update(routes=taken, route_gap=route_gap, flips=flips, dropped=dropped)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
