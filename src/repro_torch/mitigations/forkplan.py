"""Prefix-sharing fork planner: one baseline probe, many policy forks.

Every cell of a policy x scale x seed sweep replays the *same* baseline
prefix from t=0 until its policy first intervenes — the hook contract
(``repro_torch.mitigations.policy``) guarantees a policy only mutates the
engine through the public helpers (``hold_node`` / ``release_node`` /
``evict_node`` / ``restart_node``) or a non-``None``
``on_node_repair`` verdict, so the pre-first-intervention prefix is
provably shared.  This module amortizes it:

  1. **Probe**: one baseline replay per (scale, seed) carries every
     policy of the grid as a *shadow* — hooks are forwarded so each
     shadow accumulates exactly the internal state its cold run would,
     but through a :class:`_ShadowSim` proxy whose intervention helpers
     raise instead of mutating.  The probe stays bit-identical to the
     bare baseline run (extra ``K_POLICY`` bookkeeping events only
     shift event seq numbers, which carry no digest weight).
  2. **Rolling snapshots**: the probe captures
     ``ClusterSim.snapshot()`` + a pickle of each live shadow at a
     fixed sim-time cadence (``snap_period_s``) from an ``on_timer``
     hook — a safe top-of-event-loop capture point.
  3. **Fork at divergence**: the first trapped helper call (or repair
     verdict) retires the shadow and records a :class:`Divergence`
     pointing at the snapshot/pickle pair that *precedes* it.
     :func:`fork_cell` restores the engine there, reclaims the shadow's
     virtualized timers, attaches the unpickled policy, and ``run()``
     replays at most one snapshot period before the policy intervenes
     for real — bit-identical to that policy's cold run, paying only
     the divergent suffix.

Shadows that never diverge (``baseline``, the checkpoint-cadence
family — marked ``engine_inert`` — or a mutating policy whose
thresholds never trip) need no fork at all: their cold-run engine
trajectory *is* the probe's, so the sweep scores them straight from
the probe trace (see ``repro_torch.mitigations.sweep.run_fork_group``).

Invalidation: a snapshot binds the exact engine/pack/policy code that
produced it — see docs/replay_forking.md for the rules.
"""
from __future__ import annotations

import heapq
import pickle
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.cluster.scheduler import K_POLICY, ClusterSim
from repro_torch.mitigations.policy import MitigationPolicy

# probe-internal K_POLICY tags (stripped from forks by _rewire_fork_events)
SNAP_TAG = "__fork_snap__"
SHADOW_TAG = "__fork_shadow__"

# the scheduler's public intervention helpers: the first call to any of
# these is the policy-divergence point
MUTATORS = frozenset({"hold_node", "release_node", "evict_node",
                      "restart_node", "scale_fault_rates"})

DEFAULT_SNAP_PERIOD_S = 86400.0


class ShadowDiverged(Exception):
    """Control-flow signal: a shadow policy called an intervention
    helper.  Raised by :class:`_ShadowSim` *before* any engine mutation,
    aborting the hook mid-flight — the shadow's (now mid-hook) internal
    state is discarded in favor of the pickle captured at the preceding
    rolling snapshot, and the fork re-dispatches the whole hook."""

    def __init__(self, helper: str):
        self.helper = helper
        super().__init__(helper)


class _ShadowSim:
    """The sim view handed to a shadow policy during the probe run.

    Attribute reads pass straight through to the live probe sim (the
    shared prefix is bit-identical to the shadow's cold run, so its
    observations match).  The intervention helpers raise
    :class:`ShadowDiverged` instead of mutating, and
    ``push_policy_timer`` wraps the tag with the shadow's index so the
    probe can route the callback to its owner — and a fork can reclaim
    its own timers while dropping its siblings'."""

    __slots__ = ("_sim", "_idx")

    def __init__(self, sim, idx: int):
        self._sim = sim
        self._idx = idx

    def push_policy_timer(self, t: float, tag=None) -> None:
        self._sim.push_policy_timer(t, (SHADOW_TAG, self._idx, tag))

    def __getattr__(self, name):
        if name in MUTATORS:
            def _trap(*args, **kwargs):
                raise ShadowDiverged(name)
            return _trap
        return getattr(self._sim, name)


@dataclass
class Divergence:
    """Where (and from what) one policy cell forks off the baseline."""

    t: float                  # sim time of the diverging hook call
    hook: str                 # hook name it happened in
    helper: Optional[str]     # trapped helper (None: on_node_repair verdict)
    snap: object              # EngineSnapshot at the preceding cursor
    policy_pickle: Optional[bytes]  # shadow state at that cursor (None: t=0)
    cursor_t: float           # cursor sim time (fork replays t - cursor_t)


class ForkProbePolicy(MitigationPolicy):
    """The probe run's policy slot: forwards every hook to every live
    shadow (each behind its :class:`_ShadowSim` proxy), takes the
    rolling snapshots, and records each shadow's :class:`Divergence`.

    Usage::

        probe = ForkProbePolicy(shadows)
        sim = ClusterSim(spec, ..., policy=probe)
        probe.prepare(sim)       # t=0 cursor, before run()
        sim.run()
        probe.divergences[i]     # None -> shadow i never intervened
    """

    name = "__fork_probe__"

    def __init__(self, shadows, *,
                 snap_period_s: float = DEFAULT_SNAP_PERIOD_S,
                 snap_hints_s=()):
        self.shadows: list[MitigationPolicy] = list(shadows)
        self.snap_period_s = snap_period_s
        # known divergence boundaries (e.g. ensemble episode onsets):
        # a snapshot lands exactly there, armed in bind() *before* the
        # shadow binds push their own timers, so at an equal fire time
        # the snapshot's event seq is lower and it pops first — the
        # fork then replays a ~zero-length prefix
        self.snap_hints_s = sorted({float(h) for h in snap_hints_s
                                    if h > 0.0})
        n = len(self.shadows)
        self.live = [True] * n
        self.divergences: list[Optional[Divergence]] = [None] * n
        self.n_snapshots = 0
        self.snapshot_wall_s = 0.0
        self._views: list[_ShadowSim] = []
        self._cursor: Optional[tuple] = None   # (snap, {idx: bytes}, t)
        self._sim = None

    # -- probe setup ----------------------------------------------------
    def prepare(self, sim) -> None:
        """Take the t=0 cursor snapshot (call after constructing the
        probe ``ClusterSim``, before ``run()``)."""
        self._sim = sim
        self._views = [_ShadowSim(sim, i) for i in range(len(self.shadows))]
        t0 = time.time()
        self._cursor = (sim.snapshot(), None, 0.0)
        self.snapshot_wall_s += time.time() - t0
        self.n_snapshots += 1

    # -- shadow dispatch ------------------------------------------------
    def _diverge(self, idx: int, t: float, hook: str,
                 helper: Optional[str]) -> None:
        snap, pickles, cursor_t = self._cursor
        if getattr(self.shadows[idx], "engine_inert", False):
            how = helper or "repair verdict"
            raise RuntimeError(
                f"policy {self.shadows[idx].name!r} is declared "
                f"engine_inert but intervened ({hook}/{how}) — fix its "
                f"engine_inert attribute: the probe skipped its snapshot "
                f"bookkeeping, so it cannot fork")
        self.live[idx] = False
        self.divergences[idx] = Divergence(
            t=t, hook=hook, helper=helper, snap=snap,
            policy_pickle=None if pickles is None else pickles[idx],
            cursor_t=cursor_t)

    def _dispatch(self, idx: int, hook: str, t: float, call):
        if not self.live[idx]:
            return None
        try:
            return call(self.shadows[idx], self._views[idx])
        except ShadowDiverged as d:
            self._diverge(idx, t, hook, d.helper)
            return None

    def _dispatch_all(self, hook: str, t: float, call) -> None:
        for idx in range(len(self.shadows)):
            self._dispatch(idx, hook, t, call)

    def _need_snapshots(self) -> bool:
        return any(live and not getattr(s, "engine_inert", False)
                   for live, s in zip(self.live, self.shadows))

    def _arm_snap(self, t: float) -> None:
        if self.snap_period_s <= 0 or not self._need_snapshots():
            return
        nxt = t + self.snap_period_s
        if nxt < self._sim.horizon_s:
            self._sim.push_policy_timer(nxt, SNAP_TAG)

    def _take_snapshot(self, t: float) -> None:
        if not self._need_snapshots():
            return
        t0 = time.time()
        snap = self._sim.snapshot()
        pickles = {idx: pickle.dumps(s) for idx, (s, live) in
                   enumerate(zip(self.shadows, self.live))
                   if live and not getattr(s, "engine_inert", False)}
        self._cursor = (snap, pickles, t)
        self.snapshot_wall_s += time.time() - t0
        self.n_snapshots += 1

    # -- forwarded hooks ------------------------------------------------
    def bind(self, sim) -> None:
        if self._sim is not sim:
            raise ValueError(
                "ForkProbePolicy.prepare(sim) must be called before "
                "sim.run() — the t=0 cursor snapshot precedes bind")
        for h in self.snap_hints_s:
            if h < sim.horizon_s:
                sim.push_policy_timer(h, SNAP_TAG)
        self._dispatch_all("bind", 0.0, lambda s, v: s.bind(v))
        self._arm_snap(0.0)

    def on_fault(self, sim, t, fault) -> None:
        self._dispatch_all("on_fault", t,
                           lambda s, v: s.on_fault(v, t, fault))

    def on_fault_detected(self, sim, t, fault) -> None:
        self._dispatch_all("on_fault_detected", t,
                           lambda s, v: s.on_fault_detected(v, t, fault))

    def on_node_drain(self, sim, t, node_id, reason) -> None:
        self._dispatch_all("on_node_drain", t,
                           lambda s, v: s.on_node_drain(v, t, node_id,
                                                        reason))

    def on_node_repair(self, sim, t, node_id):
        for idx in range(len(self.shadows)):
            rv = self._dispatch(
                idx, "on_node_repair", t,
                lambda s, v: s.on_node_repair(v, t, node_id))
            if rv is not None and self.live[idx]:
                # a delay/HOLD verdict is an intervention: the cold run
                # would divert the repair here
                self._diverge(idx, t, "on_node_repair", None)
        return None   # the probe itself stays baseline

    def on_schedule_pass(self, sim, t) -> None:
        self._dispatch_all("on_schedule_pass", t,
                           lambda s, v: s.on_schedule_pass(v, t))

    def on_job_requeue(self, sim, t, run, state) -> None:
        self._dispatch_all("on_job_requeue", t,
                           lambda s, v: s.on_job_requeue(v, t, run, state))

    def on_timer(self, sim, t, tag) -> None:
        if type(tag) is tuple and len(tag) == 3 and tag[0] == SHADOW_TAG:
            _, idx, orig = tag
            self._dispatch(idx, "on_timer", t,
                           lambda s, v: s.on_timer(v, t, orig))
            return
        if tag == SNAP_TAG:
            self._take_snapshot(t)
            self._arm_snap(t)


def _rewire_fork_events(fork: ClusterSim, idx: int) -> None:
    """Strip the probe's instrumentation from a fork's event heap: drop
    rolling-snapshot timers and sibling shadows' virtual timers, unwrap
    this shadow's timers back to their original tags.  Event seq numbers
    keep their relative order (removals only widen gaps), so a heapify
    restores the exact pop order the policy's cold run would see."""
    events = []
    for item in fork.events:
        if item[2] == K_POLICY:
            tag = item[3]
            if tag == SNAP_TAG:
                continue
            if type(tag) is tuple and len(tag) == 3 and tag[0] == SHADOW_TAG:
                if tag[1] != idx:
                    continue
                item = (item[0], item[1], K_POLICY, tag[2])
        events.append(item)
    heapq.heapify(events)
    fork.events = events


def fork_cell(div: Divergence, *, shadow_idx: int,
              make_policy_fn) -> ClusterSim:
    """Fork one policy cell from its :class:`Divergence`: restore the
    cursor snapshot, reclaim the shadow's virtualized timers, and attach
    the policy — unpickled at the cursor instant for a mid-run cursor
    (its hook binds are skipped on resume; replayed hooks rebuild its
    state forward to the divergence point), or built fresh via
    ``make_policy_fn()`` for a t=0 cursor (the restore runs the full
    cold init path, ``bind`` included).  ``run()`` on the result pays
    the divergent suffix plus at most one snapshot period of replay."""
    if div.policy_pickle is None:
        policy = make_policy_fn()
    else:
        policy = pickle.loads(div.policy_pickle)
    fork = ClusterSim.restore(div.snap, policy=policy)
    _rewire_fork_events(fork, shadow_idx)
    return fork
