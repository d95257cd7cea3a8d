"""The port's cluster simulator (``repro_torch.cluster``, ``repro_torch.trace``)
against the JAX package's on the CPU.

The event engine is numpy on the host in both packages, copied line for
line, so the comparison is exact: the five committed engine digests
(``tests/test_sim_perf.py``'s configs, which the port carries as
``engine_version.digest_configs`` with its own ``ClusterSpec``),
element-by-element logs, bit-equal trace tables, and a
snapshot/restore that resumes to the cold run's digest.
"""
import dataclasses
import enum
import pickle

import numpy as np
import pytest

from repro.cluster import engine_version as r_ev
from repro.cluster.scheduler import ClusterSim as RClusterSim
from repro.cluster.workload import ClusterSpec as RClusterSpec
from repro.trace import TraceRecorder as RTraceRecorder
from repro_torch.cluster import engine_version as t_ev
from repro_torch.cluster.scheduler import ClusterSim
from repro_torch.cluster.workload import ClusterSpec
from repro_torch.mitigations.policy import MitigationPolicy
from repro_torch.trace import TraceRecorder
from repro_torch.trace.schema import TABLES
from tests.test_sim_perf import DIGEST_CONFIGS, engine_digest as ref_engine_digest


PORT_CONFIGS = t_ev.digest_configs()
engine_digest = t_ev.engine_digest


def port_config(name):
    """A digest config with the port's ClusterSpec."""
    spec, kw = PORT_CONFIGS[name]
    return spec, dict(kw)


# two small specs that fill every log: a busy cluster with lemon detection
# over three weeks, and an RSC-2-like one under a correlated-fault pack
SMALL = {
    "busy_lemon": (dict(name="RSC-1", n_nodes=150, jobs_per_day=600.0,
                        target_utilization=0.83, r_f=0.05),
                   dict(horizon_days=21.0, seed=5, enable_lemon_detection=True)),
    "rsc2_rack": (dict(name="RSC-2", n_nodes=120, jobs_per_day=520.0,
                       target_utilization=0.85, r_f=0.03, lemon_fraction=0.03),
                  dict(horizon_days=5.0, seed=1, scenario="rack-correlated")),
}


def plain(x):
    """A log entry as plain values: dataclasses and tuples recursively,
    enums by value (the two packages' classes differ, their values do not)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(plain(getattr(x, f.name))
                                           for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return plain(x.value)
    if isinstance(x, (tuple, list)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, plain(v)) for k, v in x.items()))
    return x


def test_engine_digests_are_the_reference_pins():
    assert t_ev.ENGINE_DIGESTS == r_ev.ENGINE_DIGESTS
    assert sorted(t_ev.ENGINE_DIGESTS) == sorted(DIGEST_CONFIGS) == sorted(PORT_CONFIGS)
    for name, (spec, kw) in DIGEST_CONFIGS.items():
        assert type(PORT_CONFIGS[name][0]) is ClusterSpec
        assert dataclasses.asdict(PORT_CONFIGS[name][0]) == dataclasses.asdict(spec)
        assert PORT_CONFIGS[name][1] == kw
    mods = t_ev.ENGINE_HASH_MODULES
    assert [m.removeprefix("repro_torch.") for m in mods] == \
        [m.removeprefix("repro.") for m in r_ev.ENGINE_HASH_MODULES]
    assert all(m.startswith("repro_torch.") for m in mods)
    # the port's digest function is the reference's (it draws from the
    # streams, so each function gets a run of its own)
    spec, kw = port_config("hi_rf_120n_4d")
    runs = [ClusterSim(spec, **kw) for _ in range(2)]
    for sim in runs:
        sim.run()
    assert engine_digest(runs[0]) == ref_engine_digest(runs[1])
    # the port's cache identity is its own
    assert t_ev.engine_version_digest() != r_ev.engine_version_digest()


@pytest.mark.parametrize("name", sorted(DIGEST_CONFIGS))
def test_port_engine_reproduces_digest(name):
    spec, kw = port_config(name)
    sim = ClusterSim(spec, **kw)
    sim.run()
    assert engine_digest(sim) == t_ev.ENGINE_DIGESTS[name]


def test_port_engine_reproduces_digest_with_spill(tmp_path):
    spec, kw = port_config("busy_80n_6d")
    rec = TraceRecorder(trace_spill_dir=str(tmp_path / "spill"))
    sim = ClusterSim(spec, **kw, recorder=rec)
    sim.run()
    assert engine_digest(sim) == t_ev.ENGINE_DIGESTS["busy_80n_6d"]
    assert rec.finalize(sim).n_rows("jobs") == sim.n_records


@pytest.mark.parametrize("name", sorted(SMALL))
def test_logs_and_trace_tables_equal_reference(name):
    spec_kw, kw = SMALL[name]
    rrec, trec = RTraceRecorder(), TraceRecorder()
    rsim = RClusterSim(RClusterSpec(**spec_kw), **kw, recorder=rrec)
    tsim = ClusterSim(ClusterSpec(**spec_kw), **kw, recorder=trec)
    rsim.run()
    tsim.run()
    assert len(tsim.records) > 300 and len(tsim.fault_log) > 10
    assert tsim.drain_log
    for log in ("records", "fault_log", "drain_log", "lemon_removal_log"):
        got, want = getattr(tsim, log), getattr(rsim, log)
        assert len(got) == len(want), log
        for i, (g, w) in enumerate(zip(got, want)):
            assert plain(g) == plain(w), (log, i)
    if kw.get("enable_lemon_detection"):
        assert tsim.lemon_removal_log
    rt, tt = rrec.finalize(rsim), trec.finalize(tsim)
    assert tt.meta == rt.meta
    for table, cols in TABLES.items():
        for col, _ in cols:
            a, b = tt.column(table, col), rt.column(table, col)
            assert a.dtype == b.dtype and np.array_equal(a, b), (table, col)


class SnapAt(MitigationPolicy):
    """Take one engine snapshot at a fixed sim time, and nothing else."""

    name = "__snap_at__"

    def __init__(self, t_s):
        self.t_s, self.snap = t_s, None

    def bind(self, sim):
        sim.push_policy_timer(self.t_s, "snap")

    def on_timer(self, sim, t, tag):
        if tag == "snap":
            self.snap = sim.snapshot()


def test_snapshot_restore_run_equals_cold_run():
    spec, kw = port_config("busy_80n_6d")
    cold = ClusterSim(spec, **kw, scenario="lablup-504")
    cold.run()
    probe = SnapAt(2.5 * 86400.0)
    sim = ClusterSim(spec, **kw, scenario="lablup-504", policy=probe)
    sim.run()
    assert probe.snap is not None and probe.snap.started
    fork = ClusterSim.restore(pickle.loads(pickle.dumps(probe.snap)))
    fork.run()
    assert engine_digest(fork) == engine_digest(cold) == engine_digest(sim)
    # a t=0 snapshot restores to the committed pin
    t0 = ClusterSim.restore(pickle.loads(pickle.dumps(ClusterSim(spec, **kw).snapshot())))
    t0.run()
    assert engine_digest(t0) == t_ev.ENGINE_DIGESTS["busy_80n_6d"]
