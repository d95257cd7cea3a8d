"""repro_torch's collectives and plans against the JAX package's:
``compressed_psum`` on 4 ranks against the reference's on 4 forced host
devices, ``pipeline_forward`` on 4 stage ranks against the reference's and
the sequential loop, ``plan_shrink`` against the reference's.

Multi-process cases run ``world`` CPU processes over gloo (``run_ranks``):
each starts its process group from a ``FileStore`` under the test's
``tmp_path`` (no TCP port, so parallel test workers cannot collide), with
one intra-op thread, and the whole run has a time limit of its own, so a
hang fails one test.  The JAX side runs in a subprocess with
``--xla_force_host_platform_device_count``, as tests/test_parallel.py does.
"""
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.runtime.elastic import plan_shrink as jplan_shrink
from repro_torch.parallel.pipeline import bubble_fraction
from repro_torch.runtime.elastic import ShrinkPlan, plan_shrink
from tests.conftest import run_subprocess_py

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 300  # seconds for a whole multi-process run

# every rank script starts with this: its process group from the FileStore
PREAMBLE = textwrap.dedent("""
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    OUT = os.environ["OUT"]
    dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE"], WORLD),
                            rank=RANK, world_size=WORLD)
""")


def run_ranks(script: str, world: int, tmp_path: pathlib.Path, *,
              timeout: float = RANK_TIMEOUT) -> list[str]:
    """Run ``PREAMBLE + script`` as ranks 0 .. world - 1 of a gloo group;
    return each rank's stdout.  Fails (and kills every rank) if any rank
    fails or the run outlasts ``timeout``."""
    store = tmp_path / f"store-{time.time_ns()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               STORE=str(store), WORLD_SIZE=str(world), OUT=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", PREAMBLE + textwrap.dedent(script)],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    return [out for _, out, _ in outs]


def run_jax(code: str, devices: int) -> None:
    r = run_subprocess_py(textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={devices}"
    """) + textwrap.dedent(code), timeout=RANK_TIMEOUT)
    assert "OK" in r.stdout, r.stderr[-4000:]


# -- compressed all-reduce ------------------------------------------------------
def test_compressed_psum_matches_jax(tmp_path):
    """The same x on 4 ranks (the reference's in_specs P()), int8 payloads
    summed as int32 and the mean block scale: the JAX package's bits, or 1
    ulp (its jit may fuse the scale's division into a product)."""
    x = np.random.default_rng(0).normal(0, 0.3, 1000).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    run_jax(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.launch.mesh import compat_make_mesh
        from repro.parallel.compression import compressed_psum
        mesh = compat_make_mesh((4,), ("data",))
        x = jnp.asarray(np.load({str(tmp_path / 'x.npy')!r}))
        np.save({str(tmp_path / 'jax.npy')!r}, np.asarray(compressed_psum(x, mesh, "data")))
        print("OK")
    """, 4)
    run_ranks("""
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.compression import compressed_psum
        mesh = make_mesh((4,), ("data",), device_type="cpu")
        x = torch.from_numpy(np.load(os.path.join(OUT, "x.npy")))
        out = compressed_psum(x, mesh, "data")
        assert out.dtype == x.dtype and out.shape == x.shape
        np.save(os.path.join(OUT, f"torch{RANK}.npy"), out.numpy())
        dist.barrier()
        dist.destroy_process_group()
    """, 4, tmp_path)
    want = np.load(tmp_path / "jax.npy")
    for r in range(4):
        got = np.load(tmp_path / f"torch{r}.npy")
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert np.all(np.abs(got - want) <= ulp), r
    assert np.abs(want - 4 * x).max() < 0.05


def test_compressed_psum_sums_distinct_payloads(tmp_path):
    """Each rank its own x, reduced over the 2-rank model groups of a 2 x 2
    mesh: the int32 sum of the group's int8 payloads times the mean of its
    block scales, to the bit (the reference's scale proxy: exact for equal
    scales, a proxy otherwise)."""
    run_ranks("""
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel import compression
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        base = torch.linspace(-1, 1, 700)
        xs = [base * (r + 1) + r for r in range(4)]
        # the model group of this rank: ranks 2 * (RANK // 2) and the next
        group = [2 * (RANK // 2), 2 * (RANK // 2) + 1]
        out = compression.compressed_psum(xs[RANK], mesh, "model")
        qs = [compression._quant_int8(xs[r]) for r in group]
        q = sum(a.to(torch.int32) for a, _ in qs).to(torch.float32)
        s = (qs[0][1] + qs[1][1]) / torch.tensor(2.0)
        want = (q * s).reshape(-1)[:700]
        assert torch.equal(out, want), (out - want).abs().max()
        dist.barrier()
        dist.destroy_process_group()
    """, 4, tmp_path)


# -- pipeline -------------------------------------------------------------------
def test_pipeline_forward_matches_jax_and_sequential(tmp_path):
    """4 stages x 2 layers, 8 microbatches: the last stage's outputs on
    every rank equal the reference's pipeline_forward and the sequential
    loop within 1e-6."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(4, 2, 16, 16)) * 0.3).astype(np.float32)
    x = rng.normal(size=(8, 2, 16)).astype(np.float32)
    np.savez(tmp_path / "in.npz", w=w, x=x)
    run_jax(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.launch.mesh import compat_make_mesh
        from repro.parallel.pipeline import pipeline_forward
        d = np.load({str(tmp_path / 'in.npz')!r})
        mesh = compat_make_mesh((4,), ("stage",))
        got = pipeline_forward(lambda wi, h: jnp.tanh(h @ wi), jnp.asarray(d["w"]),
                               jnp.asarray(d["x"]), mesh)
        np.save({str(tmp_path / 'jax.npy')!r}, np.asarray(got))
        print("OK")
    """, 4)
    run_ranks("""
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.pipeline import pipeline_forward
        d = np.load(os.path.join(OUT, "in.npz"))
        mesh = make_mesh((4,), ("stage",), device_type="cpu")
        out = pipeline_forward(lambda wi, h: torch.tanh(h @ wi), torch.from_numpy(d["w"]),
                               torch.from_numpy(d["x"]), mesh)
        np.save(os.path.join(OUT, f"torch{RANK}.npy"), out.numpy())
        dist.barrier()
        dist.destroy_process_group()
    """, 4, tmp_path)
    seq = x
    for s in range(4):
        for layer in range(2):
            seq = np.tanh(seq @ w[s, layer])
    want = np.load(tmp_path / "jax.npy")
    for r in range(4):
        got = np.load(tmp_path / f"torch{r}.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, seq, rtol=0, atol=1e-6)
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-12


def test_pipeline_forward_one_stage(tmp_path):
    """One stage: the sequential loop, with no hand-off."""
    run_ranks("""
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.pipeline import pipeline_forward
        mesh = make_mesh((1,), ("stage",), device_type="cpu")
        g = torch.Generator().manual_seed(1)
        w = {"a": torch.randn(1, 3, 8, 8, generator=g) * 0.3}
        x = torch.randn(5, 2, 8, generator=g)
        out = pipeline_forward(lambda p, h: torch.tanh(h @ p["a"]), w, x, mesh)
        want = x
        for layer in range(3):
            want = torch.tanh(want @ w["a"][0, layer])
        assert torch.equal(out, want)
        dist.barrier()
        dist.destroy_process_group()
    """, 1, tmp_path)


# -- elastic planning -------------------------------------------------------------
@settings(max_examples=60)
@given(st.integers(1, 64), st.sampled_from([1, 2, 4, 8, 16]), st.sampled_from([8, 64, 256]),
       st.sampled_from([1, 4, 16]))
def test_plan_shrink_matches_reference(n_alive, tp, old_batch, old_data):
    if n_alive < tp:
        with pytest.raises(ValueError):
            plan_shrink(n_alive, model_parallel=tp, old_global_batch=old_batch,
                        old_data=old_data)
        with pytest.raises(ValueError):
            jplan_shrink(n_alive, model_parallel=tp, old_global_batch=old_batch,
                         old_data=old_data)
        return
    got = plan_shrink(n_alive, model_parallel=tp, old_global_batch=old_batch, old_data=old_data)
    want = jplan_shrink(n_alive, model_parallel=tp, old_global_batch=old_batch,
                        old_data=old_data)
    assert isinstance(got, ShrinkPlan)
    assert (got.n_alive, got.data, got.model, got.global_batch, got.note) == (
        want.n_alive, want.data, want.model, want.global_batch, want.note)
    assert got.data * got.model <= n_alive and got.global_batch % got.data == 0


def test_plan_shrink_rejects_too_few():
    with pytest.raises(ValueError, match="TP=16"):
        plan_shrink(8, model_parallel=16, old_global_batch=256, old_data=16)
