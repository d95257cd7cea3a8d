"""Failure taxonomy (paper Table I) and differential diagnosis, copied from
``repro.core.taxonomy`` for the fault injector and the trainer."""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class Domain(enum.Flag):
    NONE = 0
    USER = enum.auto()
    SYSTEM = enum.auto()
    HARDWARE = enum.auto()
    ALL = USER | SYSTEM | HARDWARE


class Transience(enum.Enum):
    TRANSIENT = "transient"
    PERMANENT = "permanent"
    AMBIGUOUS = "ambiguous"


@dataclass(frozen=True)
class Symptom:
    name: str
    domains: Domain
    likely_causes: tuple[str, ...]
    transience: Transience
    tpu_analogue: str
    severity: str = "low"


# Table I, row by row, in the reference's order (the fault injector draws
# symptoms by index, so the order is part of its output).
TAXONOMY: dict[str, Symptom] = {s.name: s for s in [
    Symptom("oom", Domain.USER, ("user bug",), Transience.AMBIGUOUS,
            "HBM OOM in user program", "low"),
    Symptom("gpu_unavailable", Domain.SYSTEM | Domain.HARDWARE,
            ("PCIe error", "driver/BIOS", "thermals"), Transience.AMBIGUOUS,
            "TPU device unreachable / runtime init failure", "high"),
    Symptom("gpu_memory_errors", Domain.HARDWARE,
            ("thermal noise", "cosmic rays", "HBM defect or wear"),
            Transience.TRANSIENT, "HBM uncorrectable ECC", "high"),
    Symptom("gpu_driver_firmware", Domain.SYSTEM,
            ("outdated software", "high load"), Transience.TRANSIENT,
            "TPU runtime/firmware crash (GSP-timeout analogue)", "low"),
    Symptom("nvlink_error", Domain.HARDWARE,
            ("electro/material failure", "switch"), Transience.AMBIGUOUS,
            "intra-tray ICI link error", "high"),
    Symptom("ib_link_error", Domain.HARDWARE,
            ("electro/material failure", "switch"), Transience.AMBIGUOUS,
            "inter-tray ICI / OCS link error", "high"),
    Symptom("filesystem_mount", Domain.SYSTEM,
            ("failed frontend network", "drivers in D state",
             "storage backend"), Transience.TRANSIENT,
            "checkpoint/dataset volume unavailable", "high"),
    Symptom("main_memory_errors", Domain.HARDWARE,
            ("circuit wear", "thermal noise", "cosmic rays"),
            Transience.TRANSIENT, "host DRAM uncorrectable ECC", "high"),
    Symptom("ethlink_errors", Domain.HARDWARE,
            ("electro/material failure", "switch"), Transience.TRANSIENT,
            "frontend NIC/link errors", "low"),
    Symptom("pcie_errors", Domain.HARDWARE,
            ("GPU failure", "poor electrical contacts"), Transience.AMBIGUOUS,
            "host-to-TPU PCIe errors", "high"),
    Symptom("nccl_timeout", Domain.ALL,
            ("userspace crash", "deadlock", "failed hardware"),
            Transience.AMBIGUOUS, "collective timeout (ICI or host stall)",
            "low"),
    Symptom("system_services", Domain.ALL,
            ("userspace interference", "software bugs", "network partition"),
            Transience.TRANSIENT, "node agent / scheduler daemon failure",
            "low"),
]}

# Hardware-attributable symptom set (Figures 3-4 "(HW)" categories).
HW_SYMPTOMS = tuple(
    name for name, s in TAXONOMY.items()
    if s.domains & Domain.HARDWARE and name not in ("nccl_timeout", "system_services")
)


def diagnose(symptoms: list[str]) -> Domain:
    """Differential diagnosis: intersect candidate domains over observed
    symptoms (Observation 3: narrow the hypothesis space by ruling out)."""
    cand = Domain.ALL
    for s in symptoms:
        sym = TAXONOMY.get(s)
        if sym is None:
            continue
        narrowed = cand & sym.domains
        if narrowed:
            cand = narrowed
    return cand


def most_likely_cause(symptoms: list[str]) -> Optional[str]:
    """Pick the highest-priority symptom (high severity first, then
    hardware-domain) as the attribution, mirroring the paper's heuristic
    'most likely cause ... indicating whether a node should be isolated'."""
    best = None
    best_key = (-1, -1)
    for s in symptoms:
        sym = TAXONOMY.get(s)
        if sym is None:
            continue
        key = (1 if sym.severity == "high" else 0,
               1 if sym.domains & Domain.HARDWARE else 0)
        if key > best_key:
            best_key = key
            best = s
    return best
