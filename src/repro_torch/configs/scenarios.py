"""Named fault-model scenario packs (fault-model v2).

A *scenario* bundles the correlated-failure-domain modes and the staged
detection→diagnosis→repair delay distributions of
``repro_torch.cluster.failures`` into one named, reproducible configuration
accepted everywhere a simulation is launched: ``ClusterSim(...,
scenario="rack-correlated")``, ``python -m repro_torch.ensemble.run
--scenario ...``, ``python -m repro_torch.mitigations.sweep --scenario ...``
and ``python -m repro_torch.trace.report --simulate --scenario ...``.

The catalog (see docs/failure_model.md for the full parameter
rationale):

  * ``independent-v1`` — exact-legacy default: independent per-node
    exponential chains, instant v1 detection semantics.  Bit-for-bit
    identical to ``scenario=None`` (sha256-gated in
    tests/test_failure_model.py).
  * ``rack-correlated`` — §III blast radii: ToR/IB rack events and rare
    power-bus events drain multi-node blast radii in one shot.
  * ``slow-detection`` — independent faults, but detection takes tens
    of minutes (per-symptom) and diagnosis adds to repair time; what
    the Lablup operational analysis calls the detection-dominated
    regime.
  * ``lablup-504`` — a 504-GPU-scale operational profile: staged
    detection with a heavy diagnosis stage *and* mild rack correlation.

Scenario parameters are *model inputs*, not calibration outputs: the
fig11/fig13 benchmark gates pin per-scenario bands measured from this
catalog, so changing a pack here requires re-running those
calibrations.
"""
from __future__ import annotations

from repro_torch.cluster.failures import DomainFaultSpec, Scenario, StageDelays

INDEPENDENT_V1 = Scenario(
    name="independent-v1",
    description="Exact-legacy v1 fault model: independent per-node "
                "exponential chains, instant detection semantics.",
)

RACK_CORRELATED = Scenario(
    name="rack-correlated",
    description="Correlated §III blast radii: ToR/IB rack events "
                "(~one every 4 days cluster-wide, ~half the rack) and "
                "rare power-bus events on top of the independent "
                "chains.",
    domain_faults=(
        # a ToR / IB-switch incident takes out a sampled half-rack; most
        # clear on reseat/reboot (transient) within hours
        DomainFaultSpec(kind="rack", symptom="ib_link_error",
                        rate_per_day=0.25, blast_fraction=0.5,
                        repair_mean_s=2 * 3600.0, transient_p=0.7),
        # a power-bus trip is rarer, wider, and slower to restore
        DomainFaultSpec(kind="power", symptom="system_services",
                        rate_per_day=0.03, blast_fraction=0.8,
                        repair_mean_s=6 * 3600.0, transient_p=0.5),
    ),
)

SLOW_DETECTION = Scenario(
    name="slow-detection",
    description="Independent faults with Lablup-style staged "
                "detection: per-symptom detect delays in the "
                "tens-of-minutes and a diagnosis stage folded into "
                "repair time.",
    stage_delays=StageDelays(
        detect_mean_s=900.0,
        detect_mean_by_symptom={
            # silent data-path corruption surfaces slowest
            "gpu_memory_errors": 1800.0,
            "main_memory_errors": 1800.0,
            # a dead mount is noticed quickly by everything touching it
            "filesystem_mount": 300.0,
        },
        diagnose_mean_s=1800.0,
        heartbeat_mean_s=1200.0,
    ),
)

LABLUP_504 = Scenario(
    name="lablup-504",
    description="504-GPU operational profile: staged detection with a "
                "heavy diagnosis/triage stage plus mild rack "
                "correlation (small-cluster racks share switches).",
    rack_size=8,            # 63-node cluster: smaller racks
    racks_per_fabric=2,
    racks_per_power=4,
    domain_faults=(
        DomainFaultSpec(kind="rack", symptom="ib_link_error",
                        rate_per_day=0.1, blast_fraction=0.5,
                        repair_mean_s=3600.0, transient_p=0.8),
    ),
    stage_delays=StageDelays(
        detect_mean_s=300.0,
        diagnose_mean_s=3600.0,   # triage dominates time-to-repair
        heartbeat_mean_s=600.0,
    ),
)

_SCENARIOS: dict[str, Scenario] = {
    s.name: s for s in (INDEPENDENT_V1, RACK_CORRELATED, SLOW_DETECTION,
                        LABLUP_504)
}


def available_scenarios() -> list[str]:
    return sorted(_SCENARIOS)


def get_scenario(name: str) -> Scenario:
    """Resolve a scenario pack by name (KeyError lists the catalog)."""
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: "
            f"{', '.join(available_scenarios())}") from None
