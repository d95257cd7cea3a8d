"""The reference's loss, gradients and AdamW step at a tiny size, on the
CPU: against a float64 computation written without its blocks, against
``torch.optim.AdamW``, and against the port's own f32 step (the same
semantics, MoE capacity drops included)."""
import math

import pytest
import torch
import torch.nn.functional as F

from perfbench import harness, weights
from perfbench.reference import train as reference

CELLS = ("train.granite-20b.s8192", "train.mixtral-8x22b.s4096")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(name: str, *, seq: int = 64, batch: int = 4) -> tuple[dict, dict]:
    """The cell's configuration and traffic at a size a CPU test holds: every
    width cut, the same kinds of layer, mask, FFN and MoE."""
    _, cfg, traffic = harness.cell_files(name)
    cfg = dict(cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=min(cfg["n_kv_heads"], 2),
               d_head=16, d_ff=128, vocab_size=512, loss_chunk=32,
               window=min(cfg["window"], 48) if cfg["window"] else 0)
    if cfg["moe"]:
        cfg["moe"] = dict(cfg["moe"], n_experts=4, group_size=32)
    return cfg, dict(traffic, batch=batch, seq_len=seq)


def dense_loss(P: dict, cfg: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The loss over the whole batch at once: attention as one masked
    softmax a sequence, the cross entropy without chunks, the MoE by a loop
    over groups and tokens."""
    B, S = tokens.shape[0], tokens.shape[1] - 1
    d, H, KV, Dh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    L, eps = cfg["n_layers"], cfg["norm_eps"]
    window = cfg["window"] if cfg["layer_kind"] == "local" else 0
    inp, lab = tokens[:, :-1], tokens[:, 1:]
    h = P["embed"][inp]
    pos = torch.arange(S, dtype=torch.float64)
    ang = pos[:, None] / cfg["rope_theta"] ** (torch.arange(Dh // 2, dtype=torch.float64)
                                               / (Dh // 2))
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

    def rot(x):
        a, b = x[..., :Dh // 2], x[..., Dh // 2:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)

    def norm(x, w):
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * w

    i = torch.arange(S)
    allowed = i[None, :] <= i[:, None]
    if window:
        allowed = allowed & (i[:, None] - i[None, :] < window)
    lb_sum = z_sum = 0.0
    for layer in range(L):
        p = {k[len("groups/0/p0/"):]: v[layer] for k, v in P.items() if k.startswith("groups/")}
        x = norm(h, p["ln1"])
        q = rot(torch.einsum("bsd,dhk->bshk", x, p["attn/wq"]))
        k = rot(torch.einsum("bsd,dhk->bshk", x, p["attn/wk"]))
        v = torch.einsum("bsd,dhk->bshk", x, p["attn/wv"])
        k, v = k.repeat_interleave(H // KV, 2), v.repeat_interleave(H // KV, 2)
        s = torch.einsum("bqhk,bshk->bhqs", q, k) / math.sqrt(Dh)
        a = torch.softmax(s.masked_fill(~allowed, float("-inf")), -1)
        h = h + torch.einsum("bqhk,hkd->bqd", torch.einsum("bhqs,bshk->bqhk", a, v),
                             p["attn/wo"])
        x = norm(h, p["ln2"])
        if not cfg["moe"]:
            u = x @ p["ffn/w_up"]
            act = F.silu(x @ p["ffn/w_gate"]) * u if cfg["ffn_gated"] else F.gelu(
                u, approximate="tanh")
            h = h + act @ p["ffn/w_down"]
            continue
        spec = cfg["moe"]
        E, K = spec["n_experts"], spec["top_k"]
        G = reference.group_size(cfg, B * S)
        C = reference.capacity(cfg, G)
        flat = x.reshape(-1, d)
        out = torch.zeros_like(flat)
        for g0 in range(0, B * S, G):
            logits = flat[g0:g0 + G] @ p["moe/router"]
            probs = torch.softmax(logits, -1)
            ranks = probs.detach()
            count = [0] * E
            for t in range(G):
                order = sorted(range(E), key=lambda e: (-float(ranks[t, e]), e))[:K]
                gates = probs[t, order] / probs[t, order].sum()
                for j, e in enumerate(order):
                    count[e] += 1
                    if count[e] <= C:
                        xe = flat[g0 + t]
                        y = (F.silu(xe @ p["moe/w_gate"][e]) * (xe @ p["moe/w_up"][e])
                             ) @ p["moe/w_down"][e]
                        out = out.index_add(0, torch.tensor([g0 + t]), (gates[j] * y)[None])
            me = probs.mean(0)
            ce = torch.zeros(E, dtype=probs.dtype)
            for t in range(G):
                for e in sorted(range(E), key=lambda e: (-float(ranks[t, e]), e))[:K]:
                    ce[e] += 1.0 / G
            lb_sum = lb_sum + (me * ce).sum() * E * spec["load_balance_loss"]
            z_sum = z_sum + torch.logsumexp(logits, -1).pow(2).sum() * spec["router_z_loss"]
        h = h + out.view(B, S, d)
    h = norm(h, P["ln_f"])
    logits = h @ P["lm_head"]
    logz = torch.logsumexp(logits, -1)
    nll = logz - logits.gather(-1, lab[..., None])[..., 0]
    loss = (nll.sum() + 1e-4 * logz.pow(2).sum()) / (B * S)
    if cfg["moe"]:
        loss = loss + (lb_sum / (B * S // G) + z_sum / (B * S)) / L
    return loss


@pytest.mark.parametrize("name", CELLS)
def test_loss_and_gradients_equal_a_float64_computation(name):
    cfg, traffic = tiny(name, seq=64, batch=2)
    if cfg["moe"]:
        cfg["moe"] = dict(cfg["moe"], group_size=64)
    tokens = weights.token_pool(cfg["vocab_size"], 1, 2, 64, seed=7)[0]
    P = {k: t.requires_grad_() for k, t in weights.draw_all(cfg, 11, "cpu").items()}
    loss, _ = reference.loss_and_backward(P, cfg, tokens, reference.Float32)
    P64 = {k: t.detach().double().requires_grad_() for k, t in P.items()}
    want = dense_loss(P64, cfg, tokens.long())
    want.backward()
    want = float(want.detach())
    assert abs(loss - want) < 1e-5 * abs(want)
    for k, t in P.items():
        assert torch.allclose(t.grad.double(), P64[k].grad, rtol=1e-4,
                              atol=1e-5 * float(P64[k].grad.abs().max())), k


def test_adamw_step_equals_torch_adamw_in_float64():
    hp = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0,
              warmup_steps=5, total_steps=1000, min_lr_ratio=0.1)
    gen = torch.Generator().manual_seed(3)
    P = {"a": torch.randn(7, 5, generator=gen, dtype=torch.float64),
         "b": torch.randn(9, generator=gen, dtype=torch.float64)}
    Q = {k: t.clone().requires_grad_() for k, t in P.items()}
    m = {k: torch.zeros_like(t) for k, t in P.items()}
    v = {k: torch.zeros_like(t) for k, t in P.items()}
    opt = torch.optim.AdamW(Q.values(), lr=1.0, betas=(hp["b1"], hp["b2"]), eps=hp["eps"],
                            weight_decay=hp["weight_decay"])
    for t in range(1, 4):
        grads = {k: torch.randn(x.shape, generator=gen, dtype=torch.float64) * 3
                 for k, x in P.items()}
        for k in P:
            P[k].grad = grads[k].clone()
        norms, sketches = reference.adamw(P, m, v, t, hp, 7 if t == 1 else None)
        total = math.sqrt(sum(float(g.norm()) ** 2 for g in grads.values()))
        scale = min(1.0, hp["grad_clip"] / total)
        assert set(sketches) == (set(P) if t == 1 else set())
        for k, q in Q.items():
            q.grad = grads[k] * scale
            assert norms[k] == pytest.approx(float(grads[k].norm()) * scale, rel=1e-12)
            if t == 1:
                assert sketches[k] == pytest.approx(weights.sketch(q.grad, 7, "grad", k),
                                                    rel=1e-12)
        for group in opt.param_groups:
            group["lr"] = reference.lr_at(hp, t)
        opt.step()
        for k in P:
            assert torch.allclose(P[k], Q[k].detach(), rtol=1e-12, atol=1e-15), (t, k)


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_follows_the_ports_float32_step(name):
    """The port's step at f32 compute and the reference agree on the loss and
    every leaf's gradient: the same model, MoE drops included."""
    from repro_torch.models import steps

    cfg, traffic = tiny(name)
    tokens = weights.token_pool(cfg["vocab_size"], 1, 4, 64, seed=5)[0]
    P = weights.draw_all(cfg, 13, "cpu")
    arch = harness.arch_config(cfg)
    loss, _, grads = steps.loss_and_grads(arch, P, {"tokens": tokens.long()},
                                          dtype=torch.float32)
    R = {k: t.clone().requires_grad_() for k, t in P.items()}
    ref_loss, record = reference.loss_and_backward(R, cfg, tokens, reference.Float32)
    if cfg["moe"]:
        assert record["dropped"] > 0
    assert abs(float(loss) - ref_loss) < 2e-5 * abs(ref_loss)
    for k, g in grads.items():
        assert torch.allclose(g, R[k].grad, rtol=2e-3, atol=2e-4 * float(g.abs().max())), k


def test_blocked_attention_with_a_window_equals_whole_attention(monkeypatch):
    monkeypatch.setattr(reference, "ATTN_BLOCK", 16)
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(70, 6, 8, generator=gen, dtype=torch.float64)
    k = torch.randn(70, 2, 8, generator=gen, dtype=torch.float64)
    v = torch.randn(70, 2, 8, generator=gen, dtype=torch.float64)
    for window in (0, 5, 33):
        got = reference.attention(q, k, v, window, reference.Float32)
        i = torch.arange(70)
        ok = (i[None] <= i[:, None]) & ((i[:, None] - i[None] < window) if window else True)
        s = torch.einsum("qhd,khd->hqk", q, k.repeat_interleave(3, 1)) / math.sqrt(8)
        want = torch.einsum("hqk,khd->qhd", torch.softmax(s.masked_fill(~ok, -math.inf), -1),
                            v.repeat_interleave(3, 1))
        assert torch.allclose(got, want, rtol=1e-12, atol=1e-12), window


def test_the_weights_are_the_ports_declared_leaves_at_full_size():
    for name in CELLS:
        _, cfg, _ = harness.cell_files(name)
        harness.check_leaves(cfg, harness.arch_config(cfg))


def test_a_leaf_drawn_again_equals_its_first_draw():
    cfg, _ = tiny(CELLS[1])
    first = weights.draw_all(cfg, 2**31 + 77, "cpu")
    for leaf in weights.leaves(cfg):
        assert torch.equal(weights.draw(leaf, 2**31 + 77, "cpu"), first[leaf.name])
    other = weights.draw_all(cfg, 2**31 + 78, "cpu")
    assert not torch.equal(other["embed"], first["embed"])


def test_routes_followed_are_judged_and_the_own_ones_change_nothing():
    cfg, traffic = tiny(CELLS[1])
    pool = weights.token_pool(cfg["vocab_size"], 2, 4, 64, seed=9)
    own = reference.run(cfg, 21, pool, "cpu")
    again = reference.run(cfg, 21, pool, "cpu", routes=own["routes"])
    assert again["route_gap"] == 0.0 and again["flips"] == [0, 0]
    assert again["loss"] == own["loss"] and again["grad_norm"] == own["grad_norm"]
    # every token sent to its two least likely experts
    worst = [[torch.flip(r, [-1]) * 0 + (cfg["moe"]["n_experts"] - 1 - r) for r in step]
             for step in own["routes"]]
    wrong = reference.run(cfg, 21, pool, "cpu", routes=worst)
    assert wrong["route_gap"] > 0.01 and wrong["flips"][0] > 0
    half = [[r[: r.shape[0] // 2] for r in step] for step in own["routes"]]
    assert reference.run(cfg, 21, pool, "cpu", routes=half)["route_gap"] == math.inf


def test_a_sketch_reads_the_gap_between_two_tensors_and_its_direction(monkeypatch):
    from perfbench import compare

    monkeypatch.setattr(weights, "SKETCH_CHUNK", 1000)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3000, generator=gen, dtype=torch.float64)
    y = torch.randn(3000, generator=gen, dtype=torch.float64)
    a = weights.sketch(x, 9, "grad", "w")
    assert weights.sketch(x, 9, "grad", "w") == a and weights.sketch(x, 9, "grad", "v") != a
    # linear over chunks: the same directions for every tensor of the leaf
    assert weights.sketch(x + y, 9, "grad", "w") == pytest.approx(
        [p + q for p, q in zip(a, weights.sketch(y, 9, "grad", "w"))], rel=1e-9)
    # the mean square gap estimates |x - z|^2, over many gaps
    ratios = []
    for _ in range(20):
        z = x + 0.1 * torch.randn(3000, generator=gen, dtype=torch.float64)
        ratios.append((compare._sketch_gap(a, weights.sketch(z, 9, "grad", "w"))
                       / float((x - z).norm())) ** 2)
    assert 0.7 < sum(ratios) / len(ratios) < 1.3
    # a tensor of the same norm in another direction: the norms agree, the sketches do not
    turned = x[torch.randperm(3000, generator=gen)]
    assert float(turned.norm()) == pytest.approx(float(x.norm()), rel=1e-12)
    assert compare._sketch_gap(a, weights.sketch(turned, 9, "grad", "w")) > 0.4 * float(x.norm())
    assert compare._sketch_gap(a, weights.sketch(-x, 9, "grad", "w")) == pytest.approx(
        2 * compare._sketch_gap(a, [0.0] * len(a)), rel=1e-12)
