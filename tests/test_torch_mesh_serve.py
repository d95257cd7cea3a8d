"""Serving on a mesh: the prefill and decode steps of smoke qwen3-0.6b
(qk-norm, tied embeddings) and smoke mixtral-8x22b (MoE) on a 2 x 2
("data", "model") gloo mesh under ``SERVE_RULES`` (four CPU processes, as
tests/test_torch_parallel.py runs them), against the same steps without a
mesh in f32 on the same weights: next-token logits after the prefill and
after one decode step within 1e-5, the cache placed by ``cache_axes``.

On the mesh the weights are DTensors placed by ``params.shardings``, the
tokens are sharded over ``act_batch``, attention runs through the kernels'
``local_map`` route, the MoE routing on every rank alike, and decode
attention over the sequence-sharded cache joins its softmax across shards
(``ops._decode_sharded``); the references run the plain path.  The batch is
also held at ``LONG_CONTEXT_RULES`` (batch 1, the cache over every dim).
"""
from tests.test_torch_parallel import run_ranks

SCRIPT = """
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import params as pmod, transformer
from repro_torch.models.steps import make_serve_steps
from repro_torch.parallel.axes import (LONG_CONTEXT_RULES, SERVE_RULES, mesh_context,
                                       placements_for)

mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
for arch in ("qwen3-0.6b", "mixtral-8x22b"):
    cfg = smoke_config(get_arch(arch))
    defs = pmod.cast_defs(transformer.model_defs(cfg), torch.float32)
    params = pmod.materialize(defs, seed=1)
    pre, dec = make_serve_steps(cfg, dtype=torch.float32)
    for rules, B in ((SERVE_RULES, 4), (LONG_CONTEXT_RULES, 1)):
        rng = np.random.default_rng(B)
        tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, 16)))
        nxt = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, 1)))
        ref_logits, cache = pre(params, {"tokens": tokens})
        ref_next, _ = dec(params, cache, nxt)
        sh = pmod.shardings(defs, mesh, rules)
        dparams = {k: distribute_tensor(v, mesh, sh[k], src_data_rank=None)
                   for k, v in params.items()}
        with mesh_context(mesh, rules):
            place = lambda t: distribute_tensor(t, mesh, placements_for(t.shape, ("act_batch", None)),
                                                src_data_rank=None)
            logits, dcache = pre(dparams, {"tokens": place(tokens)})
            axes = transformer.cache_axes(cfg)["groups"]
            for g, group in enumerate(dcache["groups"]):
                for key, entry in group.items():
                    for name, t in entry.items():
                        assert isinstance(t, DTensor)
                        assert tuple(t.placements) == placements_for(t.shape, axes[g][key][name]), (
                            key, name)
            nxt_logits, _ = dec(dparams, dcache, place(nxt))
        for got, want in ((logits, ref_logits), (nxt_logits, ref_next)):
            err = float((got.full_tensor() - want).abs().max())
            assert err < 1e-5, (arch, B, err)
        if RANK == 0:
            print("OK", arch, B, flush=True)
"""


def test_prefill_and_decode_on_a_mesh_match_the_plain_steps(tmp_path):
    outs = run_ranks(SCRIPT, 4, tmp_path)
    assert outs[0].count("OK") == 4, outs[0]
