"""Node fault processes calibrated to the paper's attribution data.

Figure 4: per-GPU-hour attributed failure rates — IB links, filesystem
mounts, GPU memory errors and PCIe errors dominate; plus a large
unattributed NODE_FAIL share.  Figure 5: failure modes ebb and flow —
modeled as per-symptom rate-multiplier *episodes* and health-check
introduction dates (before a check exists, its faults surface as
unattributed NODE_FAILs: 'new health checks expose new failure modes').

Fault-model v2 (see docs/failure_model.md): on top of the independent
per-node exponential chains above, this module defines

  * :class:`FailureDomainMap` — nodes grouped into rack / fabric / power
    domains (the §III blast radii: a ToR switch, a fabric segment, or a
    power bus takes out many nodes in one event);
  * :class:`DomainFaultSpec` / :class:`DomainFaultProcess` — domain-level
    fault modes that drain a sampled blast radius of a sampled group in
    one event, attributed to one shared fault id;
  * :class:`StageDelays` — per-symptom detection→diagnosis delay
    distributions (Lablup-style staged recovery) replacing the v1
    instant fault→drain transition;
  * :class:`Scenario` — one named bundle of the above.  ``None`` /
    ``independent-v1`` is the exact-legacy default: no domain modes, no
    stage model, and bit-for-bit the v1 engine streams (the named packs
    live in ``repro_torch.configs.scenarios``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional

import numpy as np

from repro_torch.core.taxonomy import TAXONOMY

# Relative mix of hardware fault symptoms (Fig. 4-informed).
SYMPTOM_MIX = {
    "ib_link_error": 0.22,
    "filesystem_mount": 0.18,
    "gpu_memory_errors": 0.16,
    "pcie_errors": 0.12,
    "gpu_unavailable": 0.08,
    "nvlink_error": 0.06,
    "gpu_driver_firmware": 0.06,
    "main_memory_errors": 0.04,
    "system_services": 0.04,
    "ethlink_errors": 0.04,
}

# co-occurrence: PCIe errors imply XID-79-style GPU-unavailable signals
# 43% of the time on RSC-1 (57% of GPU-unavailable show PCIe overlap).
CO_OCCURRENCE = {
    "pcie_errors": [("gpu_unavailable", 0.43)],
    "ib_link_error": [("gpu_unavailable", 0.02)],
}

# canonical symptom order — the stable int-code vocabulary the engine's
# columnar fault log pre-seeds (repro_torch.trace.store.Interner), so symptom
# codes are identical across runs, seeds, and spill part files
SYMPTOMS: tuple[str, ...] = tuple(SYMPTOM_MIX)


@dataclass(frozen=True)
class Episode:
    """Time-windowed rate multiplier for one symptom (Fig. 5 dynamics)."""

    symptom: str
    start_day: float
    end_day: float
    multiplier: float
    note: str = ""


# An RSC-1-like 11-month trace: a driver-bug XID wave that gets fixed, a
# mount-check episode, and an early-summer IB-link spike on few nodes.
RSC1_EPISODES = (
    Episode("gpu_driver_firmware", 0, 90, 6.0, "GSP-timeout code regression"),
    Episode("filesystem_mount", 150, 230, 4.0, "mounts downing nodes"),
    Episode("ib_link_error", 240, 270, 8.0, "IB spike on a handful of nodes"),
)

# Health-check introduction days (before these, the symptom is caught only
# by the NODE_FAIL heartbeat => unattributed).
CHECK_INTRODUCED_DAY = {
    "filesystem_mount": 140.0,
    "gpu_driver_firmware": 60.0,
}


@dataclass(slots=True)
class Fault:
    """One hardware fault event (``slots=True``: a paper-scale replay logs
    thousands of these and the kill/drain paths shuffle them through event
    payloads).

    Fault-model v2 fields (defaults = the v1 sentinels, so v1 traces
    round-trip unchanged): ``domain`` is ``""`` for an independent
    per-node fault or ``"<kind>:<group>"`` (e.g. ``"rack:7"``) for a
    correlated domain event; ``fault_id`` groups the rows of one domain
    blast (every independent fault gets its own id); ``detected_t`` is
    when the detection pipeline surfaced the fault (−1.0 = not recorded,
    the v1-trace sentinel — NaN would break value-equality round-trips).
    """

    t: float
    node_id: int
    symptom: str
    co_symptoms: tuple[str, ...]
    transient: bool
    detectable_by_check: bool
    repair_s: float
    domain: str = ""
    fault_id: int = -1
    detected_t: float = -1.0


class FaultProcess:
    """Samples hardware faults per node; lemon nodes get a rate multiplier
    and a bias toward Table II lemon causes."""

    def __init__(self, n_nodes: int, r_f_per_node_day: float, *,
                 lemon_fraction: float = 0.012,
                 lemon_multiplier: float = 25.0,
                 episodes: tuple[Episode, ...] = (),
                 check_introduced: Optional[dict] = None,
                 seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.n_nodes = n_nodes
        self.r_f = r_f_per_node_day
        self.episodes = episodes
        self.check_introduced = dict(check_introduced or {})
        n_lemons = int(round(n_nodes * lemon_fraction))
        self.lemons = set(self.rng.choice(n_nodes, n_lemons, replace=False).tolist())
        self.lemon_multiplier = lemon_multiplier
        self._symptoms = list(SYMPTOM_MIX)
        self._weights = np.array([SYMPTOM_MIX[s] for s in self._symptoms])
        self._weights = self._weights / self._weights.sum()
        # per-day cache of episode-modulated cumulative symptom weights —
        # valid only when every episode window lies on whole-day boundaries
        # (then the modulated mix is piecewise-constant per day); episodes
        # with fractional start/end days fall back to exact evaluation
        self._day_weights: dict[int, np.ndarray] = {}
        self._day_cacheable = all(
            float(e.start_day).is_integer() and float(e.end_day).is_integer()
            for e in episodes)
        # shared standard-exponential stream, refilled in blocks: one bulk
        # RNG call amortizes over thousands of per-node inter-fault draws
        self._exp_buf = np.empty(0)
        self._exp_ptr = 0

    def node_rate(self, node_id: int, t_day: float) -> float:
        base = self.r_f
        if node_id in self.lemons:
            base *= self.lemon_multiplier
        return base

    def _episode_multiplier(self, symptom: str, t_day: float) -> float:
        m = 1.0
        for e in self.episodes:
            if e.symptom == symptom and e.start_day <= t_day < e.end_day:
                m *= e.multiplier
        return m

    def _std_exponential(self) -> float:
        if self._exp_ptr >= len(self._exp_buf):
            self._exp_buf = self.rng.exponential(size=2048)
            self._exp_ptr = 0
        v = self._exp_buf[self._exp_ptr]
        self._exp_ptr += 1
        return float(v)

    def _take_std_exponentials(self, n: int) -> np.ndarray:
        """``n`` draws from the shared standard-exponential stream — the
        exact values (and buffer refill points) ``n`` scalar
        ``_std_exponential`` calls would produce, in one vectorized copy."""
        out = np.empty(n)
        filled = 0
        while filled < n:
            if self._exp_ptr >= len(self._exp_buf):
                self._exp_buf = self.rng.exponential(size=2048)
                self._exp_ptr = 0
            take = min(n - filled, len(self._exp_buf) - self._exp_ptr)
            out[filled:filled + take] = \
                self._exp_buf[self._exp_ptr:self._exp_ptr + take]
            self._exp_ptr += take
            filled += take
        return out

    def _day_cum_weights(self, day: int) -> np.ndarray:
        cw = self._day_weights.get(day)
        if cw is None:
            w = self._weights * np.array(
                [self._episode_multiplier(s, float(day)) for s in self._symptoms])
            cw = np.cumsum(w / w.sum())
            self._day_weights[day] = cw
        return cw

    def sample_symptom(self, t_day: float) -> str:
        if self._day_cacheable:
            cw = self._day_cum_weights(int(t_day))
        else:  # fractional episode boundaries: evaluate at the exact time
            w = self._weights * np.array(
                [self._episode_multiplier(s, t_day) for s in self._symptoms])
            cw = np.cumsum(w / w.sum())
        i = int(np.searchsorted(cw, self.rng.random(), side="right"))
        return self._symptoms[min(i, len(self._symptoms) - 1)]

    def sample_fault(self, node_id: int, t: float) -> Fault:
        t_day = t / 86400.0
        symptom = self.sample_symptom(t_day)
        cos = []
        for co, pr in CO_OCCURRENCE.get(symptom, ()):
            if self.rng.random() < pr:
                cos.append(co)
        transient = self.rng.random() < (
            0.7 if node_id not in self.lemons else 0.3)
        detectable = t_day >= self.check_introduced.get(symptom, 0.0)
        # remediation: transient ~ hours; permanent ~ days (vendor repair)
        repair_s = (self.rng.exponential(4 * 3600.0) if transient
                    else self.rng.exponential(2 * 86400.0))
        return Fault(t, node_id, symptom, tuple(cos), transient,
                     detectable, repair_s)

    def next_fault_time(self, node_id: int, t: float) -> float:
        """Next fault on this node after time t (piecewise-constant rate,
        sampled with the current rate — episodes modulate the symptom mix
        more than the aggregate)."""
        rate_per_s = self.node_rate(node_id, t / 86400.0) / 86400.0
        return t + self._std_exponential() / max(rate_per_s, 1e-12)

    def next_fault_times(self, t: float) -> np.ndarray:
        """Batched fault delivery: the next fault time for *every* node in
        one vectorized draw.  Bit-identical to ``[next_fault_time(i, t) for
        i in range(n_nodes)]`` — same per-node rates, same draws from the
        shared exponential stream in node order, same IEEE op order — but
        one numpy call instead of ``n_nodes`` Python round-trips (the
        scheduler arms every node's initial chain with this)."""
        rates_per_s = self.node_rates() / 86400.0
        draws = self._take_std_exponentials(self.n_nodes)
        return t + draws / np.maximum(rates_per_s, 1e-12)

    def node_rates(self) -> np.ndarray:
        """Per-node hardware fault rates in failures per node-day, lemon
        multipliers applied — the shared parameter surface between the
        engine's chain arming above and the batched statistical backend
        (``repro_torch.core.backend`` feeds these to the closed-form/MC grid
        when modeling an engine-matched cluster).  Pure function of the
        process config; no RNG, so extracting it preserves the engine's
        bit-identity digests."""
        rates = np.full(self.n_nodes, self.r_f)
        if self.lemons:
            idx = np.fromiter(self.lemons, dtype=np.int64,
                              count=len(self.lemons))
            rates[idx] = rates[idx] * self.lemon_multiplier
        return rates

    def mean_rate_per_node_day(self) -> float:
        """Cluster-mean effective fault rate (failures per node-day):
        the nominal ``r_f`` lifted by the lemon tail — what the batched
        analytical grid should be fed to model this cluster's true
        injected hazard rather than the nominal one."""
        return float(self.node_rates().mean())


# -- fault-model v2: correlated domains + staged detection ---------------
class FailureDomainMap:
    """Static node→domain assignment: contiguous racks, racks grouped
    into fabric segments and power buses (the §III blast radii).

    Groups are keyed ``(kind, group_id)``; a node belongs to exactly one
    group per kind.  The map is deterministic in the node count and the
    group sizes — no RNG — so every seed of a scenario shares the same
    topology and only the *event* sampling differs."""

    KINDS = ("rack", "fabric", "power")

    def __init__(self, n_nodes: int, *, rack_size: int = 16,
                 racks_per_fabric: int = 4, racks_per_power: int = 8):
        if rack_size < 1:
            raise ValueError("rack_size must be >= 1")
        self.n_nodes = n_nodes
        self.rack_size = rack_size
        self.racks_per_fabric = max(1, racks_per_fabric)
        self.racks_per_power = max(1, racks_per_power)
        self._group_of = {}       # kind -> ndarray[node_id] = group id
        self._members = {}        # (kind, gid) -> ndarray of node ids
        nodes = np.arange(n_nodes, dtype=np.int64)
        racks = nodes // rack_size
        per_kind = {
            "rack": racks,
            "fabric": racks // self.racks_per_fabric,
            "power": racks // self.racks_per_power,
        }
        for kind, gids in per_kind.items():
            self._group_of[kind] = gids
            for gid in np.unique(gids).tolist():
                self._members[(kind, gid)] = nodes[gids == gid]

    def group_of(self, kind: str, node_id: int) -> int:
        return int(self._group_of[kind][node_id])

    def members(self, kind: str, gid: int) -> np.ndarray:
        return self._members[(kind, gid)]

    def n_groups(self, kind: str) -> int:
        return int(self._group_of[kind].max()) + 1 if self.n_nodes else 0

    def label(self, kind: str, gid: int) -> str:
        return f"{kind}:{gid}"


@dataclass(frozen=True)
class DomainFaultSpec:
    """One correlated domain-level fault mode.

    ``rate_per_day`` is the cluster-wide Poisson rate of events of this
    mode (not per-group); each event picks a uniform group of ``kind``
    and drains a binomially-sampled ``blast_fraction`` of its members
    (at least 2 — a 1-node blast is just an independent fault) with one
    shared fault id and repair time."""

    kind: str                  # "rack" | "fabric" | "power"
    symptom: str               # Table I taxonomy label for the blast rows
    rate_per_day: float        # cluster-wide events/day
    blast_fraction: float      # expected fraction of group members hit
    repair_mean_s: float       # mean of the exponential shared repair time
    transient_p: float = 0.5   # P(event clears without hardware swap)


@dataclass(frozen=True)
class StageDelays:
    """Detection→diagnosis delay distributions (Lablup-style staging).

    v1 semantics (``stages=None`` in the engine) are instant: a
    high-severity detectable fault is caught by the next health-check
    pass, a low-severity one drains immediately, and only the NODE_FAIL
    heartbeat path has a delay.  With a ``StageDelays``, every fault
    instead waits ``sample_detect`` seconds to be *detected* (surfaced
    to policies via ``on_fault_detected``) and folds a further
    ``sample_diagnose`` draw into its repair time (triage before the
    vendor clock starts).  All draws come from the engine's ``sim.rng``
    stream, so a scenario with ``stages=None`` consumes zero extra RNG.
    """

    detect_mean_s: float = 120.0
    detect_mean_by_symptom: Mapping[str, float] = field(default_factory=dict)
    diagnose_mean_s: float = 0.0
    heartbeat_mean_s: float = 600.0   # undetected-path heartbeat gap

    def detect_mean(self, symptom: str) -> float:
        return float(self.detect_mean_by_symptom.get(
            symptom, self.detect_mean_s))

    def sample_detect(self, rng, symptom: str) -> float:
        mean = self.detect_mean(symptom)
        return float(rng.exponential(mean)) if mean > 0.0 else 0.0

    def sample_diagnose(self, rng) -> float:
        return (float(rng.exponential(self.diagnose_mean_s))
                if self.diagnose_mean_s > 0.0 else 0.0)


@dataclass(frozen=True)
class Scenario:
    """One named fault-model configuration (see
    ``repro_torch.configs.scenarios`` for the shipped packs).

    ``domain_faults=()`` and ``stage_delays=None`` is exact-legacy v1:
    the engine takes the same code paths and consumes the same RNG
    draws bit-for-bit."""

    name: str
    description: str = ""
    domain_faults: tuple[DomainFaultSpec, ...] = ()
    stage_delays: Optional[StageDelays] = None
    rack_size: int = 16
    racks_per_fabric: int = 4
    racks_per_power: int = 8

    @property
    def is_legacy(self) -> bool:
        return not self.domain_faults and self.stage_delays is None

    def domain_map(self, n_nodes: int) -> FailureDomainMap:
        return FailureDomainMap(
            n_nodes, rack_size=self.rack_size,
            racks_per_fabric=self.racks_per_fabric,
            racks_per_power=self.racks_per_power)


class DomainFaultProcess:
    """Samples correlated domain-level fault events.

    Owns its own RNG stream (``seed+3`` by convention in the engine) so
    that scenarios *without* domain modes never construct one and the
    engine's per-node streams stay bit-identical to v1."""

    def __init__(self, specs: tuple[DomainFaultSpec, ...],
                 domains: FailureDomainMap, *, seed: int = 0):
        self.specs = tuple(specs)
        self.domains = domains
        self.rng = np.random.default_rng(seed)
        for s in self.specs:
            if s.kind not in FailureDomainMap.KINDS:
                raise ValueError(f"unknown domain kind {s.kind!r} "
                                 f"(expected one of {FailureDomainMap.KINDS})")

    def next_event_time(self, spec_idx: int, t: float) -> float:
        """Next event of mode ``spec_idx`` after ``t`` (cluster-wide
        Poisson)."""
        rate_per_s = self.specs[spec_idx].rate_per_day / 86400.0
        return t + float(self.rng.exponential(1.0)) / max(rate_per_s, 1e-12)

    def sample_event(self, spec_idx: int):
        """Sample one event of mode ``spec_idx``: returns
        ``(group_id, blast_node_ids, transient, repair_s)``.  The blast
        is at least 2 nodes (a 1-node event is indistinguishable from an
        independent fault and would pollute the correlation tests)."""
        spec = self.specs[spec_idx]
        gid = int(self.rng.integers(self.domains.n_groups(spec.kind)))
        members = self.domains.members(spec.kind, gid)
        k = int(self.rng.binomial(len(members), spec.blast_fraction))
        k = min(len(members), max(2, k))
        blast = self.rng.choice(members, size=k, replace=False)
        blast.sort()
        transient = bool(self.rng.random() < spec.transient_p)
        repair_s = float(self.rng.exponential(spec.repair_mean_s))
        return gid, blast, transient, repair_s
