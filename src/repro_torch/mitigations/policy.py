"""Pluggable reliability-mitigation policies for the cluster simulator.

The paper's closing contribution (§IV) is using its failure/ETTR models to
gauge software mitigations at scale.  This module makes mitigations
first-class simulation objects: a policy observes the event-driven engine
(`repro_torch.cluster.scheduler.ClusterSim`) at fixed hook points and intervenes
only through the scheduler's public helpers, so the engine core is never
forked per what-if.

Hook contract (all optional; the scheduler calls them at fixed points):

  ``bind(sim)``
      once, at the start of ``ClusterSim.run()`` before any event fires —
      reserve spares, arm timers, snapshot the spec.
  ``on_fault(sim, t, fault)``
      after every hardware fault has been processed by the engine (the
      fault is in ``sim.fault_log``; kills/drains it caused are underway).
      This is the *oracle* view — the fault exists the instant the
      hardware breaks.  Policies modeling a real operator's information
      set should use ``on_fault_detected`` instead.
  ``on_fault_detected(sim, t, fault)``
      when the detection pipeline *surfaces* the fault (fault-model v2):
      ``t == fault.detected_t`` — instantly for legacy low-severity
      faults, at the health-check / heartbeat kill for high-severity and
      undetected ones, after the sampled per-symptom detect delay under
      a staged scenario, and at the event time for correlated domain
      blasts.  A fault superseded by a harder failure on the same node
      (already DOWN at detection) never surfaces.
  ``on_node_drain(sim, t, node_id, reason)``
      after a node leaves service (drain logged, repair scheduled).
  ``on_node_repair(sim, t, node_id)``
      when a repair completes, *before* the node returns to scheduling.
      Return ``None``/``0`` to proceed, a positive number of seconds to
      delay return-to-service (the repair event re-fires and the hook is
      consulted again), or ``HOLD`` to keep the node out indefinitely —
      the policy then owns it and must call ``sim.release_node`` later.
  ``on_schedule_pass(sim, t)``
      before each tick-aligned scheduling pass.
  ``on_job_requeue(sim, t, run, state)``
      after an interrupted job re-enters the queue; ``state`` is the
      terminal state of the interrupted attempt.
  ``on_timer(sim, t, tag)``
      a timer the policy armed via ``sim.push_policy_timer(t, tag)``.
  ``checkpoint_interval_s(sim, n_gpus, realized_rf=None)``
      evaluation-side knob: the checkpoint cadence (seconds) a job of
      ``n_gpus`` runs under this policy, consumed by the sweep harness's
      ETTR accounting.  ``realized_rf`` is the interruption rate (per
      node-day, all causes) the run actually experienced — cadence
      controllers that tune to measured rates use it.  Return ``None``
      for the harness default.

Rules that keep the engine's invariants intact:

  * a policy must never touch the simulator's RNG streams (``sim.rng``,
    ``sim.faults.rng``, ``sim.gen.rng``) — randomized policies own a
    ``np.random.default_rng(seed)``;
  * interventions go through the public helpers (``hold_node`` /
    ``release_node`` / ``evict_node`` / ``restart_node`` /
    ``push_policy_timer``), never by mutating engine internals;
  * a policy that implements no hooks leaves the engine bit-for-bit
    identical to running without one (regression-tested).
"""
from __future__ import annotations

from typing import Callable, Optional

# re-exported sentinel: on_node_repair returns this to keep the node
from repro_torch.cluster.scheduler import POLICY_HOLD as HOLD  # noqa: F401


class MitigationPolicy:
    """Base policy: every hook is a no-op.  Subclasses override the hooks
    they need and register themselves with ``@register_policy``."""

    name: str = "base"
    # declares "this policy never mutates the engine" (no helper calls,
    # no repair verdicts — accounting-side knobs only).  The fork
    # planner (repro_torch.mitigations.forkplan) skips snapshot bookkeeping
    # for inert shadows: they can never diverge from the baseline, so
    # their cells are scored straight off the shared probe replay.
    engine_inert: bool = False

    def bind(self, sim) -> None:
        pass

    def on_fault(self, sim, t: float, fault) -> None:
        pass

    def on_fault_detected(self, sim, t: float, fault) -> None:
        pass

    def on_node_drain(self, sim, t: float, node_id: int,
                      reason: str) -> None:
        pass

    def on_node_repair(self, sim, t: float, node_id: int):
        return None

    def on_schedule_pass(self, sim, t: float) -> None:
        pass

    def on_job_requeue(self, sim, t: float, run, state) -> None:
        pass

    def on_timer(self, sim, t: float, tag) -> None:
        pass

    def checkpoint_interval_s(self, sim, n_gpus: int,
                              realized_rf: Optional[float] = None
                              ) -> Optional[float]:
        return None


_POLICY_REGISTRY: dict[str, Callable[..., MitigationPolicy]] = {}


def register_policy(name: str):
    """Class/factory decorator: make the policy constructible by name in
    the sweep harness (``make_policy(name, seed=...)``)."""

    def deco(factory):
        _POLICY_REGISTRY[name] = factory
        return factory

    return deco


def available_policies() -> list[str]:
    # importing the concrete policies populates the registry
    from repro_torch.mitigations import policies  # noqa: F401

    return sorted(_POLICY_REGISTRY)


def make_policy(name: str, **kwargs) -> MitigationPolicy:
    from repro_torch.mitigations import policies  # noqa: F401

    try:
        factory = _POLICY_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown mitigation policy {name!r}; available: "
            f"{', '.join(available_policies())}") from None
    return factory(**kwargs)
