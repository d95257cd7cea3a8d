"""Engine version identity: the committed bit-identity pins plus a
source hash over the replay-determining modules.

Two ingredients compose the **engine-version digest** that keys every
persisted replay artifact (the content-addressed cell cache,
``repro_torch.ensemble.cellcache``):

1. ``ENGINE_DIGESTS`` — the committed sha256 pins over five reference
   configs' full event/RNG sequences, the JAX package's literals carried
   unchanged: they fix the engine's behaviour, not its package, and the
   port's engine reproduces each of them
   (``tests/test_torch_cluster_sim.py``, ``chip_smoke.py``'s sim phase).
2. ``engine_source_hash()`` — a sha256 over the source bytes of every
   module that can influence a replay's outcome (engine, fault model,
   workload, scoring, scenario packs, policies, fork plan).  Code
   drift that does *not* trip the five pins (a new scenario pack, a
   scoring change, a policy tweak) still changes this hash.  It names the
   port's modules, so a cache directory shared with the JAX package never
   answers one package's cell from the other's entry.

Either ingredient moving ⇒ :func:`engine_version_digest` moves ⇒ every
cached cell keyed under the old engine silently misses — stale reads
are structurally impossible, no invalidation pass needed.
"""
from __future__ import annotations

import hashlib
import importlib
from functools import lru_cache

# captured on the replay-forking engine (ordered-dict bucket/node-job
# membership: copied iteration order is a language guarantee, which
# snapshot/restore requires — see docs/replay_forking.md); the same
# literals as the JAX package's, which its tests.capture_digests writes
ENGINE_DIGESTS = {
    "busy_80n_6d":
        "59f49ddf23db7bc22315e7dfb6cce9fc4ba51e01787ad58fdd84e86ca63380a6",
    "hi_rf_120n_4d":
        "b75165734f017c4e206bae41eaf81bfd84a6203fcbaadfaaec6243c23617fc35",
    "lemon_150n_21d":
        "416cddf666b69f593219082cf96898b27294a9db54556d69de163e02c2f87550",
    "rsc1_2000n_2d":
        "cce536ee60ef8dcf7c25e2a1fbc552c01650bd39879c6b57d9a114317b40235e",
    "rsc2ish_250n_6d":
        "4737a082ea6848efba886cd8ffe7cb3508bdae70a30eec4e8d07f854486226e6",
}

# every module whose source can change what a replay computes: the
# engine and its inputs (fault model, workload, scenarios), the scoring
# path a CellStats flows through, and the policy/fork machinery that a
# sweep cell's trajectory depends on.  Additions are cheap (one line);
# omissions are the only way a stale cache read can happen, so when in
# doubt a module belongs here.
ENGINE_HASH_MODULES = (
    "repro_torch.cluster.scheduler",
    "repro_torch.cluster.failures",
    "repro_torch.cluster.workload",
    "repro_torch.cluster.analysis",
    "repro_torch.core.ettr_model",
    "repro_torch.core.metrics",
    "repro_torch.core.taxonomy",
    "repro_torch.trace.schema",
    "repro_torch.trace.recorder",
    "repro_torch.trace.store",
    "repro_torch.configs.scenarios",
    "repro_torch.mitigations.policy",
    "repro_torch.mitigations.policies",
    "repro_torch.mitigations.forkplan",
    "repro_torch.ensemble.runner",
    "repro_torch.ensemble.episodes",
)


@lru_cache(maxsize=1)
def engine_source_hash() -> str:
    """sha256 over the source bytes of :data:`ENGINE_HASH_MODULES`, in
    listed order (each file prefixed by its module name, so moving code
    between modules changes the hash too)."""
    h = hashlib.sha256()
    for name in ENGINE_HASH_MODULES:
        mod = importlib.import_module(name)
        h.update(name.encode())
        with open(mod.__file__, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


@lru_cache(maxsize=1)
def engine_version_digest() -> str:
    """The engine identity that keys persisted replay artifacts:
    sha256 over the committed bit-identity pins (sorted) and the
    engine source hash."""
    h = hashlib.sha256()
    for name in sorted(ENGINE_DIGESTS):
        h.update(f"{name}={ENGINE_DIGESTS[name]}\n".encode())
    h.update(engine_source_hash().encode())
    return h.hexdigest()


def digest_configs() -> dict:
    """The five configs the pins were captured on: name -> (``ClusterSpec``,
    ``ClusterSim`` keyword arguments), the JAX package's
    ``tests/test_sim_perf.py::DIGEST_CONFIGS``."""
    from repro_torch.cluster.workload import RSC1, ClusterSpec

    return {
        "busy_80n_6d": (ClusterSpec("RSC-1", n_nodes=80, jobs_per_day=320.0,
                                    target_utilization=0.83, r_f=0.08),
                        dict(horizon_days=6.0, seed=0)),
        "rsc2ish_250n_6d": (ClusterSpec("RSC-2", n_nodes=250,
                                        jobs_per_day=1100,
                                        target_utilization=0.85, r_f=6.5e-3,
                                        lemon_fraction=0.016),
                            dict(horizon_days=6.0, seed=2)),
        "lemon_150n_21d": (ClusterSpec("RSC-1", n_nodes=150,
                                       jobs_per_day=600.0,
                                       target_utilization=0.83, r_f=0.05),
                           dict(horizon_days=21.0, seed=1,
                                enable_lemon_detection=True)),
        "rsc1_2000n_2d": (RSC1, dict(horizon_days=2.0, seed=1)),
        "hi_rf_120n_4d": (ClusterSpec("RSC-1", n_nodes=120,
                                      jobs_per_day=480.0,
                                      target_utilization=0.83, r_f=0.15),
                          dict(horizon_days=4.0, seed=3)),
    }


def engine_digest(sim) -> str:
    """sha256 over a finished run's full record / fault / drain / lemon
    sequences plus one probe draw per RNG stream (pinning the streams'
    positions); floats hash via shortest repr, so any last-bit drift
    changes it.  The JAX package's ``tests/test_sim_perf.py::engine_digest``."""
    h = hashlib.sha256()
    up = h.update
    for r in sim.records:
        up(repr((r.job_id, r.run_id, r.n_gpus, r.submit_t, r.start_t,
                 r.end_t, r.state.value, r.priority, r.hw_attributed,
                 r.symptoms, r.preempted_by)).encode())
    for f in sim.fault_log:
        up(repr((f.t, f.node_id, f.symptom, f.co_symptoms, f.transient,
                 f.detectable_by_check, f.repair_s, f.domain, f.fault_id,
                 f.detected_t)).encode())
    for d in sim.drain_log:
        up(repr(d).encode())
    for led in sim.lemon_removal_log:
        up(repr(led).encode())
    up(repr(float(sim.rng.random())).encode())
    up(repr(float(sim.faults.rng.random())).encode())
    return h.hexdigest()
