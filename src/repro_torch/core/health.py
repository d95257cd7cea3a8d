"""Severity-tiered periodic health checks (paper §II-C).

Design principles from the paper:
  * checks run every 5 minutes per node, plus scheduler prolog/epilog;
  * HIGH severity -> drain the node immediately and reschedule its jobs;
    LOW severity -> remove for remediation after the running job finishes;
  * overlapping signals are a feature (PCIe errors imply GPU-unreachable
    57%/37% of the time on RSC-1/2) — "no second job failure from a bad
    node";
  * NODE_FAIL heartbeat is the catch-all when the node can't run checks.

The same check registry drives the cluster simulator (repro_torch.cluster) and
the live runtime's fault handling (repro_torch.runtime).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from repro_torch.core.taxonomy import TAXONOMY, Symptom


class CheckResult(str, enum.Enum):
    PASS = "pass"
    WARN = "warn"
    FAIL = "fail"


class Severity(str, enum.Enum):
    HIGH = "high"  # drain node now, requeue its jobs
    LOW = "low"    # remediate after the current job exits


@dataclass(frozen=True)
class HealthCheck:
    name: str
    symptom: str                  # taxonomy key this check detects
    severity: Severity
    period_s: float = 300.0      # 5-minute cadence
    # probability the check catches the fault when present (coverage);
    # paper: overlapping checks compensate for per-check misses
    coverage: float = 0.95
    false_positive_rate: float = 1e-5  # tuned so <1% of good jobs see a fail

    def evaluate(self, active_faults: Iterable[str], rng) -> CheckResult:
        if self.symptom in active_faults:
            return CheckResult.FAIL if rng.random() < self.coverage \
                else CheckResult.PASS
        if rng.random() < self.false_positive_rate:
            return CheckResult.FAIL
        return CheckResult.PASS


# Default registry mirroring §II-C's first-category (high severity) checks
# plus the low-severity remainder.  GSP timeout models the driver-bug episode
# of Figure 5 (introduced as a check mid-trace).
DEFAULT_CHECKS: tuple[HealthCheck, ...] = (
    HealthCheck("gpu_unreachable", "gpu_unavailable", Severity.HIGH),
    HealthCheck("nvlink", "nvlink_error", Severity.HIGH),
    HealthCheck("uncorrectable_ecc", "gpu_memory_errors", Severity.HIGH),
    HealthCheck("row_remap_fail", "gpu_memory_errors", Severity.HIGH,
                coverage=0.6),
    HealthCheck("pcie", "pcie_errors", Severity.HIGH),
    HealthCheck("ib_link", "ib_link_error", Severity.HIGH),
    HealthCheck("block_device", "filesystem_mount", Severity.HIGH,
                coverage=0.5),
    HealthCheck("mounts", "filesystem_mount", Severity.HIGH),
    HealthCheck("host_ecc", "main_memory_errors", Severity.HIGH,
                coverage=0.8),
    HealthCheck("ethlink", "ethlink_errors", Severity.LOW),
    HealthCheck("gsp_timeout", "gpu_driver_firmware", Severity.LOW),
    HealthCheck("services", "system_services", Severity.LOW, coverage=0.7),
)


@dataclass
class NodeHealth:
    """Rolling health state for one node."""

    node_id: int
    active_faults: set = field(default_factory=set)
    draining: bool = False
    in_remediation: bool = False
    fired: list = field(default_factory=list)  # (t, check, result)

    def run_checks(self, t: float, rng,
                   checks: tuple[HealthCheck, ...] = DEFAULT_CHECKS
                   ) -> list[tuple[HealthCheck, CheckResult]]:
        out = []
        for c in checks:
            r = c.evaluate(self.active_faults, rng)
            if r != CheckResult.PASS:
                self.fired.append((t, c.name, r.value))
                out.append((c, r))
        return out


def highest_severity(results: list[tuple[HealthCheck, CheckResult]]
                     ) -> Optional[Severity]:
    sev = None
    for c, r in results:
        if r == CheckResult.FAIL:
            if c.severity == Severity.HIGH:
                return Severity.HIGH
            sev = Severity.LOW
    return sev
