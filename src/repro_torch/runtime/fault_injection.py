"""Live fault injection, copied from ``repro.runtime.fault_injection``.

Two modes:
  * scheduled — deterministic (step -> fault) table, for tests;
  * poisson   — failures arrive at the job-level rate N_nodes * r_f.

Same numpy RNG and symptom list as the reference, so one seed injects the
same faults in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.taxonomy import TAXONOMY


@dataclass(frozen=True)
class InjectedFault:
    symptom: str
    node_id: int = 0
    kind: str = "crash"          # crash | straggler | sdc
    slowdown: float = 1.0        # for stragglers


class SimulatedFault(RuntimeError):
    def __init__(self, fault: InjectedFault):
        super().__init__(f"injected fault: {fault.symptom} on node {fault.node_id}")
        self.fault = fault


class FaultInjector:
    def __init__(self, *, schedule: Optional[dict[int, InjectedFault]] = None,
                 rate_per_step: float = 0.0, n_nodes: int = 1,
                 seed: int = 0):
        self.schedule = dict(schedule or {})
        self.rate = rate_per_step
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)
        self.injected: list[tuple[int, InjectedFault]] = []
        self._symptoms = [s for s in TAXONOMY
                          if s not in ("oom", "nccl_timeout")]

    def poll(self, step: int) -> Optional[InjectedFault]:
        f = self.schedule.pop(step, None)  # scheduled faults fire once
        if f is None and self.rate > 0 and self.rng.random() < self.rate:
            f = InjectedFault(
                symptom=str(self.rng.choice(self._symptoms)),
                node_id=int(self.rng.integers(self.n_nodes)),
                kind="crash")
        if f is not None:
            self.injected.append((step, f))
        return f
