"""Scenario what-if *episodes* for ensemble grids.

An episode is a mid-replay perturbation applied to an otherwise plain
(scale, seed) cell at a fixed onset time: a fleet-wide fault-rate
excursion (``rf:FACTOR@DAY``) or a correlated outage that removes a
block of nodes (``outage:N@DAY``).  Before the onset the episode cell's
trajectory is bit-identical to the unperturbed cell at the same
(scale, seed) — which is exactly the shared prefix the fork plan
(``repro_torch.mitigations.forkplan``) amortizes: one carrier replay runs the
prefix, snapshots at the onset, and each episode variant forks only its
divergent suffix (``repro_torch.ensemble.runner.run_cell_group``).

:class:`EpisodeWhatIf` is a regular :class:`MitigationPolicy`: it arms
one timer at the onset and perturbs the engine **only** through the
public helpers (``scale_fault_rates`` / ``evict_node``), so the hook
contract that makes fork == cold bit-identity provable covers it.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.mitigations.policy import MitigationPolicy

_EPISODE_TAG = "__episode_onset__"


@dataclass(frozen=True)
class EpisodeSpec:
    """One parsed episode: what happens, and when."""

    kind: str            # "rf_scale" | "outage"
    onset_days: float
    factor: float = 1.0  # rf_scale: fault-rate multiplier
    n_nodes: int = 0     # outage: nodes removed at onset

    def label(self) -> str:
        """The canonical spec token (parse/label round-trips)."""
        if self.kind == "rf_scale":
            return f"rf:{self.factor:g}@{self.onset_days:g}"
        return f"outage:{self.n_nodes}@{self.onset_days:g}"


def parse_episode(token: str) -> EpisodeSpec:
    """Parse one CLI episode token.

    ``rf:2.0@4``    — double the hardware fault rate from day 4 on
    ``outage:16@4`` — remove 16 nodes (ascending id) at day 4
    """
    try:
        head, onset = token.rsplit("@", 1)
        kind, arg = head.split(":", 1)
        onset_days = float(onset)
        if onset_days <= 0:
            raise ValueError("onset must be > 0 days")
        if kind == "rf":
            spec = EpisodeSpec("rf_scale", onset_days, factor=float(arg))
            if spec.factor <= 0:
                raise ValueError("rf factor must be > 0")
        elif kind == "outage":
            spec = EpisodeSpec("outage", onset_days, n_nodes=int(arg))
            if spec.n_nodes <= 0:
                raise ValueError("outage node count must be > 0")
        else:
            raise ValueError(f"unknown episode kind {kind!r}")
    except (ValueError, TypeError) as e:
        raise ValueError(
            f"bad episode spec {token!r} (want rf:FACTOR@DAY or "
            f"outage:N@DAY): {e}") from e
    return spec


class EpisodeWhatIf(MitigationPolicy):
    """Apply one :class:`EpisodeSpec` at its onset, then stand down.

    The onset intervention is the cell's *only* engine mutation, so
    under the fork plan the divergence lands exactly on the snapshot
    hint armed at the same instant and the fork replays a ~zero-length
    prefix.  An onset at/after the horizon never fires — the cell
    degenerates to the unperturbed replay."""

    name = "episode_whatif"

    def __init__(self, spec: EpisodeSpec):
        self.spec = spec
        self.applied = False
        self.n_affected = 0

    def bind(self, sim) -> None:
        t = self.spec.onset_days * 86400.0
        if t < sim.horizon_s:
            sim.push_policy_timer(t, _EPISODE_TAG)

    def on_timer(self, sim, t, tag) -> None:
        if tag != _EPISODE_TAG or self.applied:
            return
        self.applied = True
        if self.spec.kind == "rf_scale":
            self.n_affected = sim.scale_fault_rates(t, self.spec.factor)
        else:   # outage: deterministic ascending-id walk
            n = 0
            for node_id in range(sim.spec.n_nodes):
                if n >= self.spec.n_nodes:
                    break
                if sim.evict_node(t, node_id):
                    n += 1
            self.n_affected = n
