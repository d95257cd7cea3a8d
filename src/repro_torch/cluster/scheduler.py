"""Slurm-like gang scheduler + discrete-event cluster simulator.

Faithful to the paper's §II semantics:
  * gang scheduling: all nodes allocated simultaneously; one bad node kills
    the whole job (NODE_FAIL) and forces full re-allocation;
  * auto-requeue with the same job (run) id after infra failures;
  * priority scheduling; preemption allowed only after 2 h of victim
    runtime; 7-day max job lifetime;
  * severity-tiered health checks: HIGH drains the node immediately
    (rescheduling its jobs), LOW drains after the running job finishes;
  * scheduling passes land on a 30 s tick (Slurm-style), so queue waits have
    tick granularity;
  * per-node history accumulates the lemon-detection signals of §IV-A.

Engine design (paper-scale replays — 2000 nodes x 11 months x millions of
jobs — in minutes on one CPU):
  * **lazy ticks**: scheduling passes are not pre-pushed every 30 s for the
    whole horizon; a pass is *armed* at the next tick boundary only when the
    queue or the capacity can have changed (arrival, release, repair, or a
    preemption-guard expiry).  Armed times are always tick-aligned, so the
    queue-wait granularity of the eager-tick implementation is preserved.
  * **free-GPU bucket index**: nodes are bucketed by free-GPU count
    (`_buckets[f]` = schedulable nodes with exactly ``f`` free GPUs), making
    whole-node allocation and tightest-fit placement O(1) per job instead of
    an O(n_nodes) set scan + ``np.nonzero`` per allocation attempt.
  * **priority-indexed preemption**: whole-node running jobs are indexed by
    priority (plus a guard-expiry heap); victim selection walks candidates
    in ascending priority and stops at the first victim set that covers the
    node deficit instead of materializing every eligible victim.
  * arrivals are generated as vectorized column arrays and merge-iterated
    with the event heap, never materialized as heap events.

Hot-path v2 (ensemble-throughput pass, on top of the devices above):
int-coded event kinds; per-node fault chains in a dedicated ``(t,
node_id)`` heap armed by one vectorized draw
(``FaultProcess.next_fault_times``); an allocation-free scheduling pass
(persistent sorted deferred list merge-iterated with the queue heap);
guard-eligible-prefix preemption walks; fused release/reindex/drain in
``_end_job``; ``__slots__`` everywhere hot; memoized ``JobState``.

Hot-path v3 (columnar-store pass, on top of v2):
  * **columnar append logs**: job records and faults no longer accumulate
    as per-event Python objects — ``_record``/``_handle_fault`` append
    plain tuples into chunked columnar stores
    (``repro_torch.trace.store.ChunkedStore``) whose chunks *are* the
    repro-trace/v1 columns (enums int-coded through per-column
    vocabularies).  ``TraceRecorder.finalize`` becomes a near-free
    slice/concat, and the O(total-jobs) object-list RAM floor under long
    replays disappears.  ``sim.records`` / ``sim.fault_log`` stay
    API-compatible: they are materializing views (cached, incrementally
    extended) over the stores.
  * **SoA node state**: per-node scheduling state lives in flat parallel
    arrays — ``free`` (GPUs), ``_bucket_of``, and a single merged
    ``_node_state`` status array (ACTIVE / DRAINING / DOWN replaces the
    two boolean arrays, halving status loads on the release path).
    Bucket *membership* is a per-bucket insertion-ordered dict (value
    ``None``): which member a bucket yields is part of the frozen
    event-sequence contract (sha256-gated in tests/test_sim_perf.py),
    and dict order — unlike set table order — survives
    ``copy.deepcopy``/pickle exactly, which ``snapshot()``/``fork()``
    depend on for bit-identical resume (see docs/replay_forking.md).
    The index is still maintained as O(1) membership ops while the
    status/free arrays are plain SoA.  ``node_ok`` / ``node_draining``
    remain as derived read-only views.
  * **batch-drained main loop**: consecutive arrivals and consecutive
    event-heap pops are drained in inner loops that only re-check the
    competing streams' head timestamps when they can actually have
    changed (an arrival arming an earlier tick, a repair pushing a new
    fault chain), instead of recomputing every head every iteration.
    Tie-break order (arrival <= fault/event, event <= fault) is
    preserved exactly.
  * **sorted priority index**: the preemption walk iterates an
    incrementally-maintained sorted priority-key list instead of
    re-sorting the index keys on every attempt.
  * **paused cyclic GC**: ``run()`` executes with the cyclic collector
    paused (restored on exit).  The engine's steady-state allocations
    are acyclic — refcounting frees them promptly — and the columnar
    logs keep the long-lived heap flat, so generational scans were pure
    overhead (measured 10-17%, growing with horizon).
  * **streaming spill**: ``TraceRecorder(trace_spill_dir=...)`` redirects
    every completed chunk to npz part files, so a full 330-day replay
    records in near-constant RSS (see ``repro_torch.trace.store``).

The engine's event order, RNG consumption order, and membership-op
sequence are frozen — sha256 digests of the full
record/fault/drain/lemon sequences plus RNG stream positions are pinned
across five configs (incl. lemon eviction, RSC-1 scale, and a
spill-enabled run) in tests/test_sim_perf.py.  The digests were
re-captured (``python -m tests.capture_digests``) when bucket/node-job
membership moved from sets to insertion-ordered dicts for replay
forking: the member yielded by ``popitem``/``next(iter(...))`` differs
from the old set table order, but the new order is *restorable* —
deepcopy/pickle preserve dict insertion order exactly, so a forked run
replays bit-identically (set layout depends on unreconstructible hash
table history; see docs/replay_forking.md).

Fault-model v2 (see docs/failure_model.md): per-node fault chains carry a
*generation* — the heap entry is ``(t, node_id, gen)`` and only the
current generation is live.  A chain firing on a DOWN node retires the
chain (no fault sampled, no row logged); repair/release bump the
generation and arm a fresh chain.  This fixes the v1 repair-path chain
leak, where every drain/repair cycle stacked a new chain on top of the
still-live old one and per-node fault streams compounded over long
horizons.  On top of the chains, an optional ``scenario``
(``repro_torch.configs.scenarios``) adds correlated domain-level fault events
(``K_DOMFAULT``: one rack/fabric/power blast radius drains simultaneously
under one shared fault id) and a staged detection→diagnosis→repair
pipeline (per-symptom detect delays; ``K_DETECT`` defers the
low-severity drain decision to detection time).  ``scenario=None`` (==
the ``independent-v1`` pack) takes the exact-legacy code paths and
consumes the engine RNG streams bit-for-bit.

Mitigation hook points (repro_torch.mitigations): an optional ``policy`` observes
the simulation at fixed points — ``bind`` / ``on_fault`` /
``on_fault_detected`` (fires when the detection pipeline surfaces a
fault: instantly for legacy low-severity, at the health-check/heartbeat
kill for high-severity/undetected, at the sampled detect delay under a
staged scenario) / ``on_node_drain`` / ``on_node_repair`` /
``on_schedule_pass`` / ``on_job_requeue`` /
``on_timer`` — and intervenes only through the public helpers
(``hold_node`` / ``release_node`` / ``evict_node`` / ``restart_node`` /
``push_policy_timer``).  With no policy (or a no-op policy) the engine is
bit-for-bit identical to running without the hooks: hooks never consume the
simulator's RNG streams and a no-op never pushes events, so the lazy-tick
and bucket-index invariants above survive untouched (regression-tested in
tests/test_mitigations.py).

Trace hook points (repro_torch.trace): an optional ``recorder`` rides alongside
the policy hooks and *streams* the events the engine does not already log —
node state transitions (``on_node_event``: drain / repair / hold / release /
evict) and per-tick scheduling-pass stats (``on_sched_pass``); job records
and faults come straight from the engine's columnar stores at
``recorder.finalize(sim)``.  The recorder is a pure observer: it never
consumes RNG and never pushes events, so a recorded run is bit-for-bit
identical to an unrecorded one, and ``recorder=None`` costs one ``is not
None`` check per hook site (zero-overhead-when-off; regression-tested in
tests/test_trace.py, overhead-benchmarked in benchmarks/trace_bench.py).

Observability hook points (repro_torch.obs): an optional ``obs`` (a
``MetricsRegistry``) rides the same pure-observer contract — ``bind`` /
``on_job_end`` (every job-attempt row) / ``on_fault`` (every fault row,
independent or domain) / ``on_sched_pass`` (with the pass's measured
wall time — timed only when an obs is attached) / ``on_node_down`` /
``on_node_up``.  It never consumes RNG and never pushes events, so an
instrumented run reproduces the committed engine digests bit-for-bit
(tests/test_obs.py) and ``obs=None`` costs one ``is not None`` check
per hook site (overhead-benchmarked in benchmarks/obs_bench.py).
"""
from __future__ import annotations

import copy
import gc
import heapq
import itertools
import math
from bisect import bisect_left, insort
from dataclasses import dataclass
from time import perf_counter
from typing import Optional

import numpy as np

from repro_torch.cluster.failures import (SYMPTOMS, DomainFaultProcess, Fault,
                                          FaultProcess)
from repro_torch.cluster.workload import (OUTCOME_STRS, ClusterSpec, JobRequest,
                                          WorkloadGenerator)
from repro_torch.core.lemon import LemonDetector, NodeHistory
from repro_torch.core.metrics import JobRecord, JobState
from repro_torch.core.taxonomy import TAXONOMY
from repro_torch.trace.schema import NO_JOB
from repro_torch.trace.store import ChunkedStore, Interner

PREEMPTION_GUARD_S = 2 * 3600.0
MAX_LIFETIME_S = 7 * 86400.0
SCHED_TICK_S = 30.0
CHECK_PERIOD_S = 300.0
MAX_REQUEUES = 50

# sentinel an on_node_repair hook returns to keep a repaired node out of
# service (the policy takes ownership and must later call release_node)
POLICY_HOLD = "hold"

_INF = float("inf")

# obs pass-timing sample stride: when an obs registry is attached, only
# every Nth scheduling pass is bracketed with perf_counter (the registry
# scales its wall estimates back up; see repro.obs.metrics) — timing
# every pass would cost more than the passes it measures at small scales
OBS_PASS_SAMPLE = 4

# int-coded event kinds (heap tuples: (t, seq, kind, payload)); node fault
# chains do NOT appear here — they live in their own (t, node_id, gen) heap
K_FINISH = 0
K_SCHED = 1
K_KILL = 2
K_REPAIR = 3
K_LEMON = 4
K_POLICY = 5
K_DETECT = 6     # staged low-severity detection landed (fault-model v2)
K_DOMFAULT = 7   # correlated domain-level fault event (fault-model v2)

# SoA node status codes (one merged array instead of node_ok/node_draining)
N_ACTIVE = 0     # schedulable (node_ok and not draining)
N_DRAINING = 1   # in service but leaving once its jobs finish
N_DOWN = 2       # out of service (repair / hold / evicted-idle)

# memoized enum lookups: JobState.__call__ costs an enum __new__ per job
_STATE_OF = {s.value: s for s in JobState}
_STATES = tuple(JobState)
_STATE_CODE = {s: i for i, s in enumerate(_STATES)}
_TIMEOUT = JobState.TIMEOUT
_OUT_STRS = OUTCOME_STRS
_NODE_FAIL = JobState.NODE_FAIL
_FAILED = JobState.FAILED
_PREEMPTED = JobState.PREEMPTED
_CANCELLED = JobState.CANCELLED


def _state_interner() -> Interner:
    it = Interner()
    for s in _STATES:
        it.code(s, s.value)
    return it


# v3: the per-run state lives on the JobRequest itself (they were 1:1;
# see workload.JobRequest) — RunState survives as an alias for callers
# that type-annotated against it
RunState = JobRequest


@dataclass(slots=True)
class Running:
    run: JobRequest
    job_id: int
    start_t: float
    submit_t: float
    nodes: dict  # node_id -> gpus used
    finish_seq: int  # sequence id of the scheduled finish event (for cancel)


# bump when the snapshot state inventory changes shape (a restore of an
# older snapshot must fail loudly, not resume with missing state)
SNAPSHOT_VERSION = 1


@dataclass
class EngineSnapshot:
    """Serialized ``ClusterSim`` live state (see ``ClusterSim.snapshot``).

    ``mut`` holds the deep-copied mutable object graph (heaps, queues,
    SoA node arrays, histories, logs) — isolated from the live sim at
    snapshot time, and deep-copied *again* on every restore so sibling
    forks never share mutable state.  The columnar job/fault chunks are
    the exception: they are immutable once flushed, so snapshots and
    forks share them by reference (copy-on-write — a fork only ever
    appends new chunks to its own list).  Picklable, so snapshots can
    ship across the spawn worker pool.
    """

    version: int
    # reconstruction config (restore rebuilds a ClusterSim from these,
    # then overwrites its state)
    spec: ClusterSpec
    horizon_days: float
    seed: int
    scenario: object
    episodes: tuple
    check_introduced: dict
    enable_lemon: bool
    lemon_scan_period_days: float
    detector: LemonDetector
    # dynamic state
    started: bool
    t: float
    arr_next: int
    mut: dict
    bucket_mask: int
    free_epoch: int
    full_epoch: int
    next_seq: int
    next_job_id: int
    next_fault_id: int
    rng_state: dict
    faults_rng_state: dict
    exp_buf: np.ndarray
    exp_ptr: int
    domain_rng_state: Optional[dict]
    interners: dict
    jobs_log: tuple
    faults_log: tuple
    recorder_state: Optional[dict]


class ClusterSim:
    def __init__(self, spec: ClusterSpec, *, horizon_days: float = 30.0,
                 seed: int = 0, enable_lemon_detection: bool = False,
                 lemon_scan_period_days: float = 7.0,
                 lemon_detector: Optional[LemonDetector] = None,
                 episodes=(), check_introduced=None, policy=None,
                 recorder=None, scenario=None, obs=None):
        self.spec = spec
        # fault-model v2 scenario: a failures.Scenario, a pack name (str,
        # resolved through repro_torch.configs.scenarios), or None == exact-
        # legacy independent-v1 (no domain modes, no stage model — the
        # engine takes the v1 code paths and consumes the same RNG draws)
        if isinstance(scenario, str):
            from repro_torch.configs.scenarios import get_scenario
            scenario = get_scenario(scenario)
        self.scenario = scenario
        self._stages = None if scenario is None else scenario.stage_delays
        if scenario is not None and scenario.domain_faults:
            # own RNG stream (seed+3): legacy scenarios never construct
            # one, keeping the engine's streams bit-identical to v1
            self._domain_proc = DomainFaultProcess(
                scenario.domain_faults, scenario.domain_map(spec.n_nodes),
                seed=seed + 3)
        else:
            self._domain_proc = None
        # optional repro_torch.mitigations.MitigationPolicy (duck-typed; the
        # scheduler never imports the mitigations package)
        self.policy = policy
        # optional repro_torch.trace.TraceRecorder (duck-typed, same reasoning)
        self.recorder = recorder
        # optional repro_torch.obs.MetricsRegistry (duck-typed, same reasoning)
        self.obs = obs
        self.seed = seed
        self.horizon_s = horizon_days * 86400.0
        self.rng = np.random.default_rng(seed + 1)
        self.gen = WorkloadGenerator(spec, seed=seed)
        self.faults = FaultProcess(
            spec.n_nodes, spec.r_f, lemon_fraction=spec.lemon_fraction,
            lemon_multiplier=spec.lemon_rate_multiplier,
            episodes=episodes, check_introduced=check_introduced,
            seed=seed + 2)
        self.enable_lemon = enable_lemon_detection
        self.lemon_scan_period_s = lemon_scan_period_days * 86400.0
        self.detector = lemon_detector or LemonDetector()

        n = spec.n_nodes
        g = spec.gpus_per_node
        self._g = g
        # SoA node state: parallel flat arrays indexed by node id
        self.free = [g] * n
        self._node_state = [N_ACTIVE] * n
        # insertion-ordered dicts (value None) rather than sets: the
        # member a bucket / node-job walk yields is digest-pinned, and
        # dict iteration order survives deepcopy/pickle exactly (set
        # table layout does not), which snapshot()/fork() require
        self.node_jobs: list[dict] = [{} for _ in range(n)]
        # free-GPU bucket index: _buckets[f] holds schedulable nodes with
        # exactly f free GPUs (f >= 1); _bucket_of[i] = -1 means unindexed
        # (node down, draining, or fully allocated)
        self._buckets: list[dict] = [{} for _ in range(g + 1)]
        self._buckets[g] = dict.fromkeys(range(n))
        self._bucket_of = [g] * n
        # occupancy bitmask over the bucket index (bit f set iff
        # _buckets[f] is non-empty): tightest-fit placement finds its
        # bucket with one shift + lowest-set-bit instead of a scan, and
        # a hopeless allocation fails in O(1)
        self._bucket_mask = 1 << g
        self.full_free = self._buckets[g]          # alias for introspection

        self.queue: list[tuple] = []   # (-priority, submit_t, seq, RunState)
        # jobs a scheduling pass could not place, in pop (= sorted) order;
        # the next pass merge-iterates this with the queue heap instead of
        # re-pushing every deferral (see _schedule_pass)
        self._deferred: list[tuple] = []
        self._def_scratch: list[tuple] = []
        # capacity epoch: bumped whenever free GPUs can have *increased*
        # (job release, node repair/release/drain-cancel).  A deferred
        # job whose allocation failed at epoch E provably fails again
        # while the epoch is still E (allocations only consume), so the
        # pass skips its alloc attempt outright — preemption-eligible
        # jobs are exempt (guard expiry unlocks victims over time).
        # _def_epochs[i] is the failure epoch of _deferred[i] (-1 =
        # always retry).  Whole-node jobs compare against _full_epoch
        # instead — their allocations depend only on the full-node
        # bucket, which gains members far more rarely than "any GPU
        # freed", so their skip fires on almost every retry.
        self._free_epoch = 0
        self._full_epoch = 0
        self._def_epochs: list[int] = []
        self._def_ep_scratch: list[int] = []
        self.running: dict[int, Running] = {}
        # whole-node running jobs by priority (preemption victim index):
        # job_id -> start_t, insertion-ordered.  Insertion time == start
        # time, so each inner dict is sorted by start_t; equal-priority
        # victims are preempted in start order (matching the seed's stable
        # sort) and the guard-eligibility scan can stop at the first
        # too-young entry instead of walking every candidate.
        # _prio_keys mirrors the dict's keys as a sorted list so the
        # preemption walk never re-sorts.
        self._running_by_prio: dict[int, dict[int, float]] = {}
        self._prio_keys: list[int] = []
        # (start_t + guard, job_id) for whole-node jobs: next guard expiry
        self._guard_heap: list[tuple] = []
        self.events: list[tuple] = []  # (t, seq, kind, payload)
        # per-node fault chains: (t, node_id, gen).  _chain_gen[i] is the
        # node's current chain generation; a popped entry whose gen is
        # stale (the chain was re-armed at repair/release) is discarded,
        # and an entry firing on a DOWN node retires the chain (the
        # repair path arms a fresh generation).  Invariant: exactly one
        # live (current-gen) entry per in-service node, at most one for
        # a DOWN node — see _live_chain_counts().
        self._fault_heap: list[tuple] = []
        self._chain_gen = [0] * n
        self._fault_ids = itertools.count(1)
        self._seq = itertools.count()
        # columnar logs (hot-path v3): rows append as int-coded tuples;
        # .records / .fault_log materialize lazily for API compatibility
        self._state_int = _state_interner()
        self._sym_int = Interner()
        self._sym_int.code((), "")                 # code 0 == no symptoms
        self._fsym_int = Interner()
        self._fsym_int.seed(SYMPTOMS)              # stable symptom codes
        self._cos_int = Interner()
        self._cos_int.code((), "")
        self._dom_int = Interner()
        self._dom_int.code("")                     # code 0 == independent
        self._jobs_log = ChunkedStore("jobs", interners={
            "state": self._state_int, "symptoms": self._sym_int})
        self._faults_log = ChunkedStore("faults", interners={
            "symptom": self._fsym_int, "co_symptoms": self._cos_int,
            "domain": self._dom_int})
        self._records_view: list[JobRecord] = []
        self._faults_view: list[Fault] = []
        self.drain_log: list[tuple] = []
        self.histories = [NodeHistory(i) for i in range(n)]
        self.removed_lemons: set[int] = set()
        self.lemon_removal_log: list[tuple] = []
        self._job_ids = itertools.count(1)
        self._now = 0.0
        self._armed: list[float] = []   # outstanding sched-pass ticks (heap)
        self._pass_t = -1.0             # tick of the pass currently running
        self._trace_spill_dir: Optional[str] = None
        # replay forking (see snapshot()/restore()): _arr_next counts the
        # arrivals consumed so far (the workload cursor a restored run
        # regenerates its arrival stream from); _resumed routes run()
        # into the resume path (skip init + hook binds, reuse restored
        # heaps); _started distinguishes a t=0 snapshot (full cold init
        # on restore) from a mid-run one
        self._arr_next = 0
        self._started = False
        self._resumed = False

    # -- columnar-log views (API compatibility) -------------------------
    @property
    def n_records(self) -> int:
        """Job-attempt count without materializing record objects."""
        return self._jobs_log.rows

    @property
    def records(self) -> list[JobRecord]:
        """The job log as ``JobRecord`` objects — a cached materializing
        view over the columnar store, extended incrementally so mid-run
        reads (adaptive policies) stay cheap."""
        lst = self._records_view
        log = self._jobs_log
        if len(lst) < log.rows:
            states = self._state_int.raw
            syms = self._sym_int.raw
            append = lst.append
            for (jid, rid, g, sub, st, en, sc, prio, hw, sy,
                 pb) in log.iter_rows(len(lst)):
                append(JobRecord(jid, rid, g, sub, st, en, states[sc],
                                 prio, hw, syms[sy],
                                 None if pb == NO_JOB else pb))
        return lst

    @property
    def fault_log(self) -> list[Fault]:
        lst = self._faults_view
        log = self._faults_log
        if len(lst) < log.rows:
            syms = self._fsym_int.raw
            cos = self._cos_int.raw
            doms = self._dom_int.raw
            append = lst.append
            for (t, nid, sc, cc, tr, det, rep, dm, fid,
                 dt) in log.iter_rows(len(lst)):
                append(Fault(t, nid, syms[sc], cos[cc], tr, det, rep,
                             doms[dm], fid, dt))
        return lst

    # derived read-only views of the merged status array (policies and
    # tests read these; all writes go through the engine/helpers)
    @property
    def node_ok(self) -> list[bool]:
        return [s != N_DOWN for s in self._node_state]

    @property
    def node_draining(self) -> list[bool]:
        return [s == N_DRAINING for s in self._node_state]

    def _enable_trace_spill(self, spill_dir: str) -> None:
        """Stream the job/fault logs' chunks to ``spill_dir`` (called by
        ``TraceRecorder.bind`` before any rows exist), and switch arrival
        generation to disk-backed blocks (``spill_arrival_blocks``) so
        the replay's RSS stays flat in the horizon."""
        self._jobs_log.spill_to(spill_dir)
        self._faults_log.spill_to(spill_dir)
        self._trace_spill_dir = spill_dir

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: int, payload) -> int:
        seq = next(self._seq)
        heapq.heappush(self.events, (t, seq, kind, payload))
        return seq

    def _arm_sched(self, t: float) -> None:
        """Arm a scheduling pass at the next 30 s tick boundary (lazy-tick
        invariant: passes only ever run at k*SCHED_TICK_S).

        Dedupe: if a pass is already armed at or before the requested tick,
        skip — that pass re-arms per its outcome (progress -> next tick,
        guard-blocked -> earliest expiry), so coverage is preserved
        inductively without ever stacking duplicate events on one tick."""
        if not self.queue and not self._deferred:
            return
        tick = SCHED_TICK_S * math.ceil(t / SCHED_TICK_S)
        if tick <= self._pass_t:   # same-tick re-arm from inside the pass
            return
        armed = self._armed
        if armed and armed[0] <= tick:
            return
        heapq.heappush(armed, tick)
        self._push(tick, K_SCHED, None)

    # -- node capacity management --------------------------------------
    def _reindex(self, i: int) -> None:
        f = self.free[i]
        b = f if (f > 0 and self._node_state[i] == N_ACTIVE) else -1
        old = self._bucket_of[i]
        if b != old:
            if old >= 0:
                s = self._buckets[old]
                s.pop(i, None)
                if not s:
                    self._bucket_mask &= ~(1 << old)
            if b >= 0:
                self._buckets[b][i] = None
                self._bucket_mask |= 1 << b
                self._free_epoch += 1   # capacity became reachable
                if b == self._g:
                    self._full_epoch += 1
            self._bucket_of[i] = b

    def _alloc_nodes(self, req_gpus: int) -> Optional[dict]:
        g = self._g
        buckets = self._buckets
        if req_gpus >= g:
            full = buckets[g]
            n_nodes = -(-req_gpus // g)
            if len(full) < n_nodes:
                return None
            free = self.free
            bucket_of = self._bucket_of
            out = {}
            for _ in range(n_nodes):
                i = full.popitem()[0]
                free[i] = 0
                bucket_of[i] = -1
                out[i] = g
            if not full:
                self._bucket_mask &= ~(1 << g)
            return out
        # small job: tightest fit — smallest free-GPU bucket that fits,
        # falling back to a fully-free node; the occupancy bitmask jumps
        # straight to that bucket (or fails in O(1)).  A bucketed node is
        # schedulable and not draining by construction, so the reindex is
        # inlined.
        mm = self._bucket_mask >> req_gpus
        if mm == 0:
            return None
        f = req_gpus + ((mm & -mm).bit_length() - 1)
        b = buckets[f]
        i = next(iter(b))
        nf = f - req_gpus              # f == g (full node) => nf > 0
        self.free[i] = nf
        del b[i]
        if not b:
            self._bucket_mask &= ~(1 << f)
        if nf > 0:
            buckets[nf][i] = None
            self._bucket_mask |= 1 << nf
            self._bucket_of[i] = nf
        else:
            self._bucket_of[i] = -1
        return {i: req_gpus}

    # -- job lifecycle ---------------------------------------------------
    def _start_job(self, t: float, run: RunState, nodes: dict,
                   submit_t: float) -> None:
        job_id = next(self._job_ids)
        rem = run.remaining_s
        dur = rem if rem < MAX_LIFETIME_S else MAX_LIFETIME_S
        seq = next(self._seq)
        heapq.heappush(self.events, (t + dur, seq, K_FINISH, job_id))
        r = Running(run, job_id, t, submit_t, nodes, seq)
        self.running[job_id] = r
        if run.n_gpus >= self._g:
            prio = run.priority
            d = self._running_by_prio.get(prio)
            if d is None:
                d = self._running_by_prio[prio] = {}
                insort(self._prio_keys, prio)
            d[job_id] = t
            heapq.heappush(self._guard_heap,
                           (t + PREEMPTION_GUARD_S, job_id))
        node_jobs = self.node_jobs
        if run.n_gpus <= 8:   # single-node job (n_nodes == 1)
            histories = self.histories
            for i in nodes:
                node_jobs[i][job_id] = None
                histories[i].single_node_jobs += 1
        else:
            for i in nodes:
                node_jobs[i][job_id] = None

    def _record(self, r: Running, t: float, state: JobState,
                hw: bool = False, symptoms=(), preempted_by=None) -> None:
        """Append one job-attempt row to the columnar log (int-coded
        state/symptoms; was a ``JobRecord`` object append in v2)."""
        run = r.run
        self._jobs_log.append((
            r.job_id, run.run_id, run.n_gpus, r.submit_t, r.start_t, t,
            _STATE_CODE[state], run.priority, hw,
            self._sym_int.code(tuple(symptoms), "|".join(symptoms))
            if symptoms else 0,
            NO_JOB if preempted_by is None else preempted_by))
        if self.obs is not None:
            self.obs.on_job_end(t, state, run.n_gpus, r.start_t, hw)

    def _end_job(self, r: Running, t: float) -> None:
        """Remove a finished/interrupted job and release its nodes (the
        release/reindex/drain-check loop is fused and inlined — this is the
        hottest per-job path after the scheduling pass itself)."""
        job_id = r.job_id
        del self.running[job_id]
        self._free_epoch += 1          # this job's GPUs come back
        run = r.run
        g = self._g
        free = self.free
        state = self._node_state
        node_jobs = self.node_jobs
        if run.n_gpus >= g:
            prio = run.priority
            s = self._running_by_prio.get(prio)
            if s is not None:
                s.pop(job_id, None)
                if not s:
                    del self._running_by_prio[prio]
                    self._prio_keys.remove(prio)
            # whole-node fast path: every node was allocated in full
            # (free == 0, bucket_of == -1, sole occupant), so the
            # release is a direct re-add to the full bucket — no old
            # bucket to leave and the drain check needs no set probe
            full = self._buckets[g]
            bucket_of = self._bucket_of
            for i in r.nodes:
                node_jobs[i].pop(job_id, None)
                free[i] = g
                si = state[i]
                if si == N_ACTIVE:
                    full[i] = None
                    bucket_of[i] = g
                    self._bucket_mask |= 1 << g
                    self._full_epoch += 1
                elif si == N_DRAINING:
                    self._drain_now(i, None, reason="low_sev_after_job",
                                    now=self._now)
        else:
            buckets = self._buckets
            bucket_of = self._bucket_of
            for i, g_used in r.nodes.items():
                node_jobs[i].pop(job_id, None)
                f = free[i] + g_used
                free[i] = f
                si = state[i]
                b = f if si == N_ACTIVE else -1
                old = bucket_of[i]
                if b != old:
                    if old >= 0:
                        s = buckets[old]
                        s.pop(i, None)
                        if not s:
                            self._bucket_mask &= ~(1 << old)
                    if b >= 0:
                        buckets[b][i] = None
                        self._bucket_mask |= 1 << b
                        if b == g:
                            self._full_epoch += 1
                    bucket_of[i] = b
                if si == N_DRAINING and not node_jobs[i]:
                    self._drain_now(i, None, reason="low_sev_after_job",
                                    now=self._now)
        # inline arm-dedupe fast path: a pass already armed at or before
        # now covers this release (same skip _arm_sched would take)
        armed = self._armed
        if not (armed and armed[0] <= self._now):
            self._arm_sched(self._now)

    def _interrupt(self, r: Running, t: float, state: JobState,
                   hw: bool, symptoms=(), preempted_by=None,
                   requeue: bool = True) -> None:
        ran = t - r.start_t
        r.run.productive_s += ran
        r.run.remaining_s = max(r.run.remaining_s - ran, 0.0)
        self._record(r, t, state, hw, symptoms, preempted_by)
        self._end_job(r, t)
        # lemon signals
        if state is _NODE_FAIL:
            multi = r.run.n_nodes > 1
            rng_random = self.rng.random
            for i in r.nodes:
                h = self.histories[i]
                if multi:
                    h.multi_node_node_fails += 1
                else:
                    h.single_node_node_fails += 1
                if rng_random() < 0.3:
                    h.excl_jobid_count += 1
        if requeue and r.run.attempts < MAX_REQUEUES and r.run.remaining_s > 1.0:
            r.run.attempts += 1
            self._enqueue(t, r.run)
            if self.policy is not None:
                self.policy.on_job_requeue(self, t, r.run, state)

    def _enqueue(self, t: float, run: RunState) -> None:
        heapq.heappush(self.queue,
                       (-run.priority, t, next(self._seq), run))
        armed = self._armed
        if not (armed and armed[0] <= t):
            self._arm_sched(t)

    # -- node fault handling ----------------------------------------------
    def _drain_now(self, node_id: int, fault: Optional[Fault],
                   reason: str = "", now: Optional[float] = None,
                   repair_s: Optional[float] = None) -> None:
        if self._node_state[node_id] == N_DOWN:
            return
        self._node_state[node_id] = N_DOWN
        self._reindex(node_id)
        self.histories[node_id].out_count += 1
        if repair_s is None:
            repair_s = fault.repair_s if fault else 3600.0
        t0 = fault.t if fault else (now if now is not None else self._now)
        self.drain_log.append((t0, node_id, reason))
        self._push(t0 + repair_s, K_REPAIR, node_id)
        if self.recorder is not None:
            self.recorder.on_node_event(t0, node_id, "drain", reason)
        if self.obs is not None:
            self.obs.on_node_down(t0, node_id, reason)
        if self.policy is not None:
            self.policy.on_node_drain(self, t0, node_id, reason)

    def _log_fault(self, fault: Fault) -> None:
        cos = fault.co_symptoms
        self._faults_log.append((
            fault.t, fault.node_id, self._fsym_int.code(fault.symptom),
            self._cos_int.code(cos, "|".join(cos)) if cos else 0,
            fault.transient, fault.detectable_by_check, fault.repair_s,
            self._dom_int.code(fault.domain) if fault.domain else 0,
            fault.fault_id, fault.detected_t))
        if self.obs is not None:
            self.obs.on_fault(fault)

    def _fault_detected(self, t: float, fault: Fault) -> None:
        """The detection pipeline surfaced ``fault`` at ``t`` — the point
        where a real operator (and a reactive policy) first *sees* it."""
        if self.policy is not None:
            self.policy.on_fault_detected(self, t, fault)

    def _handle_fault(self, t: float, fault: Fault) -> None:
        """Handle one independent per-node fault.  Only called for
        in-service nodes (the main loop retires chain firings on DOWN
        nodes); the detection stage is resolved *before* logging so the
        fault row carries its ``detected_t``.

        Legacy (``stages is None``) detection semantics: a high-severity
        detectable fault is caught by the next health-check pass
        (uniform within the 5-min cadence), a low-severity one is
        detected instantly and drains after running jobs complete, an
        undetected fault surfaces through the NODE_FAIL heartbeat
        (exponential gap).  With a ``StageDelays``, per-symptom detect
        delays replace the check cadence and a diagnose delay folds into
        the repair time."""
        node_id = fault.node_id
        fault.fault_id = next(self._fault_ids)
        stages = self._stages
        sev = TAXONOMY[fault.symptom].severity
        low_sev_now = False
        kill = None
        if fault.detectable_by_check and sev == "high":
            # health check catches it; the kill + drain happen at
            # detection time (deferred event for causality)
            if stages is None:
                delay = float(self.rng.uniform(0, CHECK_PERIOD_S))
            else:
                delay = stages.sample_detect(self.rng, fault.symptom)
            fault.detected_t = t + delay
            kill = (node_id, fault, _NODE_FAIL, True,
                    f"check:{fault.symptom}")
        elif fault.detectable_by_check:
            # low severity: drain after running jobs complete, starting
            # when the detection pipeline surfaces the fault
            if stages is None:
                fault.detected_t = t
                low_sev_now = True
            else:
                fault.detected_t = t + stages.sample_detect(
                    self.rng, fault.symptom)
                low_sev_now = fault.detected_t <= t
        else:
            # undetected: the job crashes; NODE_FAIL heartbeat catch-all
            mean = 600.0 if stages is None else stages.heartbeat_mean_s
            delay = float(self.rng.exponential(mean))
            hw_attr = self.rng.random() < 0.5  # a check fires in the window
            fault.detected_t = t + delay
            kill = (node_id, fault, _FAILED if hw_attr else _NODE_FAIL,
                    hw_attr, "node_fail_heartbeat")
        if stages is not None:
            fault.repair_s += stages.sample_diagnose(self.rng)
        self._log_fault(fault)
        h = self.histories[node_id]
        if fault.symptom.startswith("gpu"):
            h.xid_cnt += 1
        if not fault.transient:
            h.tickets += 1
        # next fault on this node: same chain generation, dedicated heap
        # (exactly one live entry per in-service node — the chain retires
        # at drain and a fresh generation arms at repair/release)
        heapq.heappush(self._fault_heap,
                       (self.faults.next_fault_time(node_id, t), node_id,
                        self._chain_gen[node_id]))
        if kill is not None:
            self._push(fault.detected_t, K_KILL, kill)
        elif low_sev_now:
            self._fault_detected(fault.detected_t, fault)
            if self.node_jobs[node_id]:
                self._node_state[node_id] = N_DRAINING
                self._reindex(node_id)
            else:
                self._drain_now(node_id, fault,
                                reason=f"check:{fault.symptom}")
        else:
            # staged low severity: the drain decision waits for detection
            self._push(fault.detected_t, K_DETECT, fault)

    def _handle_kill(self, t: float, payload: tuple) -> None:
        node_id, fault, state, hw, reason = payload
        if self._node_state[node_id] == N_DOWN:
            return
        self._fault_detected(t, fault)
        for j in list(self.node_jobs[node_id]):
            r = self.running.get(j)
            if r is not None:
                self._interrupt(r, t, state, hw=hw,
                                symptoms=(fault.symptom, *fault.co_symptoms))
        fault2 = Fault(t, node_id, fault.symptom, fault.co_symptoms,
                       fault.transient, fault.detectable_by_check,
                       fault.repair_s, fault.domain, fault.fault_id,
                       fault.detected_t)
        self._drain_now(node_id, fault2, reason=reason)

    def _handle_detect(self, t: float, fault: Fault) -> None:
        """Staged low-severity detection landed: surface the fault to
        policies and start the drain (the node may have gone DOWN to a
        harder failure while the detection was pending — then the stale
        detection is moot)."""
        node_id = fault.node_id
        if self._node_state[node_id] == N_DOWN:
            return
        self._fault_detected(t, fault)
        if self.node_jobs[node_id]:
            self._node_state[node_id] = N_DRAINING
            self._reindex(node_id)
        else:
            # re-stamp at detection time: the repair clock must start at
            # t, not at the (past) injection time
            fault2 = Fault(t, node_id, fault.symptom, fault.co_symptoms,
                           fault.transient, fault.detectable_by_check,
                           fault.repair_s, fault.domain, fault.fault_id,
                           fault.detected_t)
            self._drain_now(node_id, fault2, reason=f"check:{fault.symptom}")

    def _handle_domain_fault(self, t: float, spec_idx: int) -> None:
        """One correlated domain-level event: a sampled blast radius of
        one rack/fabric/power group drains *simultaneously* under one
        shared fault id and repair time (domain outages are self-evident
        — ``detected_t == t``).  Already-DOWN members are skipped (their
        capacity is already out)."""
        proc = self._domain_proc
        spec = proc.specs[spec_idx]
        gid, blast, transient, repair_s = proc.sample_event(spec_idx)
        fid = next(self._fault_ids)
        label = proc.domains.label(spec.kind, gid)
        reason = f"domain:{label}"
        policy = self.policy
        histories = self.histories
        running = self.running
        for node_id in blast.tolist():
            if self._node_state[node_id] == N_DOWN:
                continue
            fault = Fault(t, node_id, spec.symptom, (), transient, True,
                          repair_s, label, fid, t)
            self._log_fault(fault)
            h = histories[node_id]
            if spec.symptom.startswith("gpu"):
                h.xid_cnt += 1
            if not transient:
                h.tickets += 1
            if policy is not None:
                policy.on_fault(self, t, fault)
            self._fault_detected(t, fault)
            for j in list(self.node_jobs[node_id]):
                r = running.get(j)
                if r is not None:
                    self._interrupt(r, t, _NODE_FAIL, hw=True,
                                    symptoms=(spec.symptom,))
            self._drain_now(node_id, fault, reason=reason)
        # re-arm this mode's cluster-wide Poisson clock
        self._push(proc.next_event_time(spec_idx, t), K_DOMFAULT, spec_idx)

    def _live_chain_counts(self) -> list[int]:
        """Live (current-generation) fault-chain heap entries per node —
        the conservation invariant behind the repair-path chain-leak
        fix: exactly one for every in-service node, at most one for a
        DOWN node (a pending entry retires lazily on pop).  Debug/test
        helper; O(heap)."""
        counts = [0] * self.spec.n_nodes
        gens = self._chain_gen
        for _, node_id, gen in self._fault_heap:
            if gen == gens[node_id]:
                counts[node_id] += 1
        return counts

    # -- scheduling pass ---------------------------------------------------
    def _try_preempt(self, t: float, run: RunState) -> tuple[bool, int]:
        """Free whole nodes for a high-priority multi-node job.  Returns
        (enough victims freed, #victims interrupted).

        Victims are taken in ascending-priority order from the whole-node
        index (insertion = start order within a priority), skipping jobs
        still inside the 2 h guard, and the walk stops as soon as the node
        deficit is covered.  The candidate priorities come from the
        maintained sorted key list (snapshotted below ``p`` — interrupts
        mutate the index while we walk it)."""
        need = run.n_nodes
        deficit = need - len(self._buckets[self._g])
        if deficit <= 0:
            return True, 0
        p = run.priority
        guard_cutoff = t - PREEMPTION_GUARD_S
        by_prio = self._running_by_prio
        running = self.running
        # paper Fig. 8 accounting: a preemption is "second order" only when
        # the instigator is a requeued job recovering from a failure
        instigator = run.run_id if run.attempts > 0 else None
        freed = 0
        n_victims = 0
        prio_keys = self._prio_keys
        for prio in prio_keys[:bisect_left(prio_keys, p)]:
            # guard-eligible prefix only: values are start_t in insertion
            # (= start) order, so the first too-young entry ends the scan;
            # snapshot before interrupting (interrupts pop from this dict)
            prefix = []
            for jid, start_t in by_prio[prio].items():
                if start_t > guard_cutoff:
                    break
                prefix.append(jid)
            for jid in prefix:
                r = running[jid]
                freed += len(r.nodes)
                n_victims += 1
                self._interrupt(r, t, _PREEMPTED, hw=False,
                                preempted_by=instigator)
                if freed >= deficit:
                    return True, n_victims
        return False, n_victims

    def _next_guard_expiry(self, t: float) -> float:
        """Earliest future preemption-guard expiry among running whole-node
        jobs (inf if none); stale/past entries are discarded lazily."""
        heap = self._guard_heap
        while heap:
            expiry, jid = heap[0]
            r = self.running.get(jid)
            if r is None or expiry <= t:
                heapq.heappop(heap)
                continue
            return expiry
        return _INF

    def _schedule_pass(self, t: float) -> tuple[int, int, bool]:
        """One tick-aligned scheduling pass.  Returns (n_started,
        n_preempted, blocked): placements/preemptions > 0 mean progress
        was made (so a retry at the next tick can make further progress);
        ``blocked`` — a preemption-eligible job is waiting only on the 2 h
        victim guard.

        Allocation-free inner loop: the pass consumes the global priority
        order by merge-iterating the queue heap with the previous pass's
        deferred list (which is sorted, because deferrals happen in pop
        order and leftover entries are >= every consumed one), and this
        pass's deferrals accumulate in a reused scratch list that becomes
        the next pass's deferred list — a job deferred N passes in a row
        costs zero heap operations after its first pop.

        Capacity-epoch fast path (v3): a deferred job re-defers without
        an allocation attempt while ``_free_epoch`` still equals the
        epoch its last attempt failed at — allocations only *consume*
        capacity, so the retry provably fails identically and skipping
        it cannot change the event sequence.  Preemption-eligible jobs
        (priority >= 7, multi-node) always retry: the 2 h guard unlocks
        new victims as time passes."""
        queue = self.queue
        deferred = self._deferred
        def_eps = self._def_epochs
        new_def = self._def_scratch
        new_eps = self._def_ep_scratch
        di = 0
        dn = len(deferred)
        scanned = 0
        n_started = 0
        n_preempted = 0
        n_def = 0
        blocked_preemptor = False
        # once a preemption attempt at priority p fails, every eligible
        # victim below p has already been interrupted — later attempts at
        # priority <= p this pass can be skipped outright
        exhausted_below = -1
        g = self._g
        alloc = self._alloc_nodes
        start_job = self._start_job
        heappop = heapq.heappop
        epoch = self._free_epoch
        full_ep = self._full_epoch
        while scanned < 200:
            tag = None
            if queue:
                if di < dn and deferred[di] <= queue[0]:
                    item = deferred[di]
                    tag = def_eps[di]
                    di += 1
                else:
                    item = heappop(queue)
            elif di < dn:
                item = deferred[di]
                tag = def_eps[di]
                di += 1
            else:
                break
            scanned += 1
            run = item[3]
            n_gpus = run.n_gpus
            if tag is not None and tag == (full_ep if n_gpus >= g
                                           else epoch):
                # capacity of this job's class unchanged since its last
                # failed attempt: the retry provably fails identically
                new_def.append(item)
                new_eps.append(tag)
                n_def += 1
                if n_def > 50:
                    break
                continue
            nodes = alloc(n_gpus)
            preemptor = False
            if nodes is None and run.priority >= 7 and n_gpus > g:
                preemptor = True
                if run.priority <= exhausted_below:
                    blocked_preemptor = True
                else:
                    ok, n_victims = self._try_preempt(t, run)
                    n_preempted += n_victims
                    # even a failed attempt may have freed victims —
                    # stale-epoch tags/skips would change behavior
                    epoch = self._free_epoch
                    full_ep = self._full_epoch
                    if ok:
                        nodes = alloc(n_gpus)
                    else:
                        blocked_preemptor = True
                        exhausted_below = run.priority
            if nodes is None:
                new_def.append(item)
                new_eps.append(-1 if preemptor else
                               (full_ep if n_gpus >= g else epoch))
                n_def += 1
                # gang scheduling: don't let smaller lower-priority jobs jump
                # far ahead; allow limited backfill depth
                if n_def > 50:
                    break
                continue
            start_job(t, run, nodes, item[1])
            n_started += 1
        if di < dn:
            new_def.extend(deferred[di:])
            new_eps.extend(def_eps[di:])
        self._deferred = new_def
        self._def_epochs = new_eps
        deferred.clear()
        def_eps.clear()
        self._def_scratch = deferred
        self._def_ep_scratch = def_eps
        return n_started, n_preempted, blocked_preemptor

    # -- lemon scan ---------------------------------------------------------
    def _lemon_scan(self, t: float) -> None:
        # scan every node's history, including nodes currently out for
        # repair — lemon signals persist across drains
        verdicts = self.detector.scan(self.histories)
        for v in verdicts:
            if v.is_lemon:
                self.evict_node(t, v.node_id, v.tripped)

    # -- mitigation-policy helpers ------------------------------------------
    def evict_node(self, t: float, node_id: int, tripped=(),
                   replace_after_s: float = 4 * 3600.0) -> bool:
        """Remove a repeat-offender node and swap in a healthy replacement
        (paper §IV-A lemon eviction).  Busy nodes drain after their running
        jobs finish; idle nodes leave immediately and the replacement
        arrives ``replace_after_s`` later.  Returns False if the node was
        already evicted."""
        if node_id in self.removed_lemons:
            return False
        if self.recorder is not None:
            self.recorder.on_node_event(t, node_id, "evict",
                                        ",".join(tripped))
        self.lemon_removal_log.append((t, node_id, tuple(tripped)))
        self.removed_lemons.add(node_id)
        # replace with a healthy node: clear fault process lemon flag
        self.faults.lemons.discard(node_id)
        if self._node_state[node_id] != N_DOWN:
            if self.node_jobs[node_id]:
                # proactive removal: drain after running jobs finish
                self._node_state[node_id] = N_DRAINING
                self._reindex(node_id)
            else:
                self._node_state[node_id] = N_DOWN
                self._reindex(node_id)
                self._push(t + replace_after_s, K_REPAIR, node_id)
        return True

    def hold_node(self, node_id: int) -> bool:
        """Take an idle, healthy node out of scheduling without logging a
        drain (warm-spare reservation).  The caller owns the node until it
        calls release_node."""
        if self._node_state[node_id] == N_DOWN or self.node_jobs[node_id]:
            return False
        self._node_state[node_id] = N_DOWN
        self._reindex(node_id)
        if self.recorder is not None:
            self.recorder.on_node_event(self._now, node_id, "hold")
        return True

    def release_node(self, t: float, node_id: int) -> bool:
        """Return a held node to scheduling.  The hold may have retired
        the node's fault chain (an entry firing while the node is DOWN
        is discarded), so release bumps the chain generation and arms a
        fresh chain — inter-fault times are memoryless exponentials, so
        re-arming at release is statistically identical to the chain
        having stayed live, while preserving the exactly-one-live-chain
        invariant (no compounding across hold/release cycles)."""
        if self._node_state[node_id] != N_DOWN:
            return False
        if node_id in self.removed_lemons:
            self.removed_lemons.discard(node_id)  # replaced node
        self._node_state[node_id] = N_ACTIVE
        self._reindex(node_id)
        self._arm_sched(t)
        self._chain_gen[node_id] += 1
        heapq.heappush(self._fault_heap,
                       (self.faults.next_fault_time(node_id, t), node_id,
                        self._chain_gen[node_id]))
        if self.recorder is not None:
            self.recorder.on_node_event(t, node_id, "release")
        return True

    def restart_node(self, t: float, node_id: int,
                     repair_s: float = 1800.0,
                     reason: str = "preemptive_restart") -> bool:
        """Controlled restart of an in-service node: running jobs are
        requeued as REQUEUED (an orderly kill, not a NODE_FAIL) and the node
        returns after ``repair_s``.  A node already draining toward
        remediation is left alone (interrupting its last job would fire the
        pending low-severity drain with its own repair time, silently
        discarding ``repair_s``/``reason``) — returns False."""
        if self._node_state[node_id] != N_ACTIVE:
            return False
        for j in list(self.node_jobs[node_id]):
            r = self.running.get(j)
            if r is not None:
                self._interrupt(r, t, JobState.REQUEUED, hw=False)
        self._drain_now(node_id, None, reason=reason, now=t,
                        repair_s=repair_s)
        return True

    def scale_fault_rates(self, t: float, factor: float) -> int:
        """Multiply the base hardware fault rate by ``factor`` from sim
        time ``t`` onward (scenario what-if episodes: a fleet-wide rate
        excursion; lemon multipliers stack on top as before).  Every
        in-service node's fault chain is re-armed at the new rate —
        inter-fault gaps are memoryless exponentials, so re-arming
        mid-gap is statistically identical to the chain having run at
        the new rate since ``t`` — preserving the exactly-one-live-chain
        invariant; DOWN nodes pick the new rate up at return-to-service.
        Correlated *domain* fault processes (fault-model v2 packs) keep
        their own rates.  Chains re-arm in node-id order (one draw each
        off the shared exponential stream), so RNG consumption is
        deterministic.  Returns the number of chains re-armed."""
        if factor <= 0.0:
            raise ValueError(f"scale_fault_rates: factor must be > 0, "
                             f"got {factor}")
        self.faults.r_f *= factor
        n = 0
        for node_id in range(self.spec.n_nodes):
            if self._node_state[node_id] == N_DOWN:
                continue
            self._chain_gen[node_id] += 1
            heapq.heappush(self._fault_heap,
                           (self.faults.next_fault_time(node_id, t),
                            node_id, self._chain_gen[node_id]))
            n += 1
        return n

    def push_policy_timer(self, t: float, tag=None) -> None:
        """Arm a policy callback: on_timer(sim, t, tag) fires at time t."""
        self._push(t, K_POLICY, tag)

    def _return_to_service(self, t: float, node_id: int) -> None:
        if node_id in self.removed_lemons:
            self.removed_lemons.discard(node_id)  # replaced node
        self._node_state[node_id] = N_ACTIVE
        self._reindex(node_id)
        self._arm_sched(t)
        # retire whatever chain entry the downtime left behind (the old
        # generation goes stale) and arm a fresh chain — the repair-path
        # chain-leak fix: repairs previously stacked a new chain on top
        # of the still-live old one, compounding the node's fault rate
        # with every drain/repair cycle
        self._chain_gen[node_id] += 1
        heapq.heappush(self._fault_heap,
                       (self.faults.next_fault_time(node_id, t), node_id,
                        self._chain_gen[node_id]))
        if self.recorder is not None:
            self.recorder.on_node_event(t, node_id, "repair")
        if self.obs is not None:
            self.obs.on_node_up(t, node_id)

    # -- snapshot / restore (copy-on-write replay forking) -------------------
    def snapshot(self) -> EngineSnapshot:
        """Serialize the engine's live state into an :class:`EngineSnapshot`
        that :meth:`restore` resumes **bit-identically** (same event order,
        same RNG stream positions, same sha256 engine digest at the
        horizon — see docs/replay_forking.md and tests/test_forking.py).

        Pure observer: consumes no RNG, pushes no events, and mutates
        nothing — snapshotting mid-run leaves the live sim's trajectory
        untouched (the columnar staging buffers are captured as shared
        immutable tuples, not flushed).

        Safe capture points: before ``run()`` (a t=0 snapshot), or
        mid-run from inside a ``policy.on_timer`` / ``policy.on_fault``
        hook — at both, the current event is fully processed and the
        main loop re-derives every stream head from the captured heaps.
        NOT safe inside ``on_schedule_pass`` (the pass's K_SCHED event
        is consumed but the pass hasn't run — guarded below) or from
        ``bind`` (the fault chains aren't armed yet).  Snapshots of
        spilling runs are refused: spilled chunks live in part files
        owned by the original run.
        """
        if self._trace_spill_dir is not None:
            raise ValueError(
                "cannot snapshot a spilling run — replay forking "
                "requires in-memory stores (drop trace_spill_dir)")
        if self._pass_t != -1.0:
            raise ValueError(
                "cannot snapshot from inside a scheduling pass — "
                "snapshot from on_timer/on_fault, not on_schedule_pass")
        # one deepcopy over the whole mutable graph: shared objects
        # (a JobRequest referenced from the queue AND a deferred entry,
        # Fault payloads) keep their cross-references via the shared memo
        mut = copy.deepcopy({
            "free": self.free, "node_state": self._node_state,
            "node_jobs": self.node_jobs, "buckets": self._buckets,
            "bucket_of": self._bucket_of, "queue": self.queue,
            "deferred": self._deferred, "def_epochs": self._def_epochs,
            "running": self.running,
            "running_by_prio": self._running_by_prio,
            "prio_keys": self._prio_keys, "guard_heap": self._guard_heap,
            "events": self.events, "fault_heap": self._fault_heap,
            "chain_gen": self._chain_gen, "armed": self._armed,
            "drain_log": self.drain_log, "histories": self.histories,
            "removed_lemons": self.removed_lemons,
            "lemon_removal_log": self.lemon_removal_log,
            "lemons": self.faults.lemons,
        })
        faults = self.faults
        return EngineSnapshot(
            version=SNAPSHOT_VERSION,
            spec=self.spec,
            horizon_days=self.horizon_s / 86400.0,
            seed=self.seed,
            scenario=self.scenario,
            episodes=faults.episodes,
            check_introduced=dict(faults.check_introduced),
            enable_lemon=self.enable_lemon,
            lemon_scan_period_days=self.lemon_scan_period_s / 86400.0,
            detector=self.detector,
            started=self._started,
            t=self._now,
            arr_next=self._arr_next,
            mut=mut,
            bucket_mask=self._bucket_mask,
            free_epoch=self._free_epoch,
            full_epoch=self._full_epoch,
            # itertools.count peek without consuming: __reduce__ carries
            # the next value
            next_seq=self._seq.__reduce__()[1][0],
            next_job_id=self._job_ids.__reduce__()[1][0],
            next_fault_id=self._fault_ids.__reduce__()[1][0],
            rng_state=self.rng.bit_generator.state,
            faults_rng_state=faults.rng.bit_generator.state,
            exp_buf=faults._exp_buf.copy(),
            exp_ptr=faults._exp_ptr,
            domain_rng_state=(None if self._domain_proc is None
                              else self._domain_proc.rng.bit_generator.state),
            interners={
                "state": self._state_int.snapshot_state(),
                "symptoms": self._sym_int.snapshot_state(),
                "fsym": self._fsym_int.snapshot_state(),
                "cos": self._cos_int.snapshot_state(),
                "dom": self._dom_int.snapshot_state(),
            },
            jobs_log=self._jobs_log.snapshot_state(),
            faults_log=self._faults_log.snapshot_state(),
            recorder_state=(None if self.recorder is None
                            else self.recorder.snapshot_state()),
        )

    @classmethod
    def restore(cls, snap: EngineSnapshot, *, policy=None) -> "ClusterSim":
        """Rebuild a ``ClusterSim`` from an :class:`EngineSnapshot` and
        prepare it to resume exactly where the snapshot was taken —
        ``run()`` on the result continues the replay bit-identically
        (a t=0 snapshot restores to a full cold run reproducing the
        committed ``ENGINE_DIGESTS``).

        ``policy`` attaches a mitigation policy to the fork.  For a
        started (mid-run) snapshot, hook binds are *skipped* on resume:
        the policy's own state must already correspond to the snapshot
        time (the fork planner unpickles the policy captured alongside
        the snapshot — see ``repro_torch.mitigations.forkplan``).  A recorder
        captured in the snapshot is re-attached pre-bound; a fresh
        recorder/obs cannot be added to a started snapshot (their binds
        already ran in the original run).  Each restore deep-copies the
        snapshot's mutable graph, so one snapshot forks any number of
        independent suffixes.
        """
        if snap.version != SNAPSHOT_VERSION:
            raise ValueError(
                f"EngineSnapshot v{snap.version} is not compatible with "
                f"this engine (expects v{SNAPSHOT_VERSION}) — re-snapshot "
                "from a fresh baseline run")
        sim = cls(snap.spec, horizon_days=snap.horizon_days,
                  seed=snap.seed, enable_lemon_detection=snap.enable_lemon,
                  lemon_scan_period_days=snap.lemon_scan_period_days,
                  lemon_detector=snap.detector, episodes=snap.episodes,
                  check_introduced=snap.check_introduced,
                  scenario=snap.scenario, policy=policy)
        d = copy.deepcopy(snap.mut)
        sim.free = d["free"]
        sim._node_state = d["node_state"]
        sim.node_jobs = d["node_jobs"]
        sim._buckets = d["buckets"]
        sim._bucket_of = d["bucket_of"]
        sim._bucket_mask = snap.bucket_mask
        sim.full_free = sim._buckets[sim._g]   # re-bind the alias
        sim.queue = d["queue"]
        sim._deferred = d["deferred"]
        sim._def_epochs = d["def_epochs"]
        sim._def_scratch = []
        sim._def_ep_scratch = []
        sim._free_epoch = snap.free_epoch
        sim._full_epoch = snap.full_epoch
        sim.running = d["running"]
        sim._running_by_prio = d["running_by_prio"]
        sim._prio_keys = d["prio_keys"]
        sim._guard_heap = d["guard_heap"]
        sim.events = d["events"]
        sim._fault_heap = d["fault_heap"]
        sim._chain_gen = d["chain_gen"]
        sim._armed = d["armed"]
        sim.drain_log = d["drain_log"]
        sim.histories = d["histories"]
        sim.removed_lemons = d["removed_lemons"]
        sim.lemon_removal_log = d["lemon_removal_log"]
        sim._seq = itertools.count(snap.next_seq)
        sim._job_ids = itertools.count(snap.next_job_id)
        sim._fault_ids = itertools.count(snap.next_fault_id)
        sim.rng.bit_generator.state = snap.rng_state
        faults = sim.faults
        faults.lemons = d["lemons"]
        faults.rng.bit_generator.state = snap.faults_rng_state
        faults._exp_buf = snap.exp_buf.copy()
        faults._exp_ptr = snap.exp_ptr
        if snap.domain_rng_state is not None:
            sim._domain_proc.rng.bit_generator.state = snap.domain_rng_state
        # columnar logs: rebuild vocabularies, adopt the shared chunks
        sim._state_int = Interner.from_state(snap.interners["state"])
        sim._sym_int = Interner.from_state(snap.interners["symptoms"])
        sim._fsym_int = Interner.from_state(snap.interners["fsym"])
        sim._cos_int = Interner.from_state(snap.interners["cos"])
        sim._dom_int = Interner.from_state(snap.interners["dom"])
        sim._jobs_log = ChunkedStore("jobs", interners={
            "state": sim._state_int, "symptoms": sim._sym_int})
        sim._jobs_log.restore_state(snap.jobs_log)
        sim._faults_log = ChunkedStore("faults", interners={
            "symptom": sim._fsym_int, "co_symptoms": sim._cos_int,
            "domain": sim._dom_int})
        sim._faults_log.restore_state(snap.faults_log)
        sim._records_view = []
        sim._faults_view = []
        sim._now = snap.t
        sim._pass_t = -1.0
        sim._arr_next = snap.arr_next
        sim._started = snap.started
        sim._resumed = snap.started
        if snap.recorder_state is not None:
            from repro_torch.trace.recorder import TraceRecorder

            sim.recorder = TraceRecorder.from_snapshot_state(
                snap.recorder_state, sim=sim)
            # a not-yet-started snapshot restores to the normal cold
            # path, where _run() binds hooks — let bind re-run there
            sim.recorder._bound = snap.started
        return sim

    def fork(self, *, policy=None) -> "ClusterSim":
        """``restore(snapshot())`` in one call: an independent sim that
        resumes this one's exact state (optionally under ``policy``)."""
        return ClusterSim.restore(self.snapshot(), policy=policy)

    # -- main loop -----------------------------------------------------------
    def run(self) -> None:
        # the cyclic collector is pure overhead here: steady-state
        # allocations (heap tuples, Running/RunState, log rows) are
        # acyclic and refcount-freed, and the columnar logs keep the
        # long-lived heap flat — pause it, restore on exit
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            self._run()
        finally:
            if gc_was_enabled:
                gc.enable()

    def _arrival_windows(self, skip: int = 0):
        """Yield arrival column *windows* — (submit_t, n_gpus,
        duration_s, priority, outcome_code, first_job_id) as plain lists
        (fast scalar access in the loop).  Windowing bounds the boxed-
        scalar footprint: the v2 loop ``tolist()``-ed the whole horizon
        up front, which alone put ~450 MB of Python floats/ints under an
        11-month replay.  In spill mode the windows come straight off
        the disk-backed arrival parts and each part is deleted once
        consumed, so arrival data never exceeds ~one block in RAM.

        ``skip`` (resume path): drop the first ``skip`` arrivals — a
        restored run regenerates the full deterministic arrival stream
        (``generate_arrays`` is a pure function of spec/seed/horizon on
        a fresh generator) and windows from its snapshot cursor."""
        spill_dir = self._trace_spill_dir
        if spill_dir is None:
            arrivals = self.gen.generate_arrays(self.horizon_s / 86400.0)
            n = len(arrivals)
            w = 131072
            for lo in range(skip, n, w):
                hi = lo + w if lo + w < n else n
                yield (arrivals.submit_t[lo:hi].tolist(),
                       arrivals.n_gpus[lo:hi].tolist(),
                       arrivals.duration_s[lo:hi].tolist(),
                       arrivals.priority[lo:hi].tolist(),
                       arrivals.outcome_code[lo:hi].tolist(),
                       arrivals.start_job_id + lo)
            return
        assert skip == 0, "spill-mode runs cannot be restored"
        import os

        parts = self.gen.spill_arrival_blocks(self.horizon_s / 86400.0,
                                              spill_dir)
        jid0 = 0
        for tmpl, m in parts:
            paths = [tmpl.format(col=c)
                     for c in ("t", "gpus", "dur", "prio", "outcome")]
            cols = [np.load(path).tolist() for path in paths]
            yield (*cols, jid0)
            jid0 += m
            for path in paths:   # consumed: reclaim the disk space
                os.remove(path)

    def _run(self) -> None:
        if not self._resumed:
            self._started = True
            # hooks bind before arrival generation: spill mode must be
            # configured first (neither bind consumes engine RNG or seq)
            if self.recorder is not None:
                self.recorder.bind(self)
            if self.policy is not None:
                self.policy.bind(self)
            if self.obs is not None:
                self.obs.bind(self)
            windows = self._arrival_windows()
        else:
            # resuming a restored mid-run snapshot: hook binds already
            # ran in the original run (a restored recorder re-attaches
            # pre-bound; the forked policy's state corresponds to the
            # snapshot time), the fault chains / domain clocks / lemon
            # scans are already armed in the restored heaps, and the
            # arrival stream regenerates from the snapshot cursor
            windows = self._arrival_windows(self._arr_next)
        win = next(windows, None)
        if win is None:
            arr_t = arr_gpus = arr_dur = arr_prio = arr_out = ()
            jid0 = 0
            n_arr = 0
        else:
            arr_t, arr_gpus, arr_dur, arr_prio, arr_out, jid0 = win
            n_arr = len(arr_t)
        ai = 0

        if not self._resumed:
            # batched fault delivery: the initial per-node chain is one
            # vectorized draw (same RNG stream as n scalar calls)
            # heapified into the dedicated fault stream (generation 0)
            first = self.faults.next_fault_times(0.0).tolist()
            fheap = [(first[i], i, 0) for i in range(self.spec.n_nodes)]
            heapq.heapify(fheap)
            self._fault_heap = fheap
            if self._domain_proc is not None:
                for k in range(len(self._domain_proc.specs)):
                    self._push(self._domain_proc.next_event_time(k, 0.0),
                               K_DOMFAULT, k)
            if self.enable_lemon:
                t = self.lemon_scan_period_s
                while t < self.horizon_s:
                    self._push(t, K_LEMON, None)
                    t += self.lemon_scan_period_s
            self._now = 0.0
        else:
            fheap = self._fault_heap
        events = self.events
        armed = self._armed
        horizon = self.horizon_s
        running = self.running
        policy = self.policy
        node_state = self._node_state
        chain_gen = self._chain_gen
        sample_fault = self.faults.sample_fault
        heappop = heapq.heappop
        state_of = _STATE_OF
        outs = _OUT_STRS
        enqueue = self._enqueue
        # hoisted bound hook: the sched branch is the hottest recorder site
        on_sched_pass = (None if self.recorder is None
                         else self.recorder.on_sched_pass)
        # hoisted obs hook (same reasoning); the pass wall-clock is only
        # measured when an obs is attached, and only on every
        # OBS_PASS_SAMPLE-th pass (wall_s=-1.0 marks unsampled passes) —
        # sampling keeps the perf_counter pair off most passes
        obs_sched_pass = (None if self.obs is None
                          else self.obs.on_sched_pass)
        obs_pass_i = 0
        while True:
            t_ev = events[0][0] if events else _INF
            t_f = fheap[0][0] if fheap else _INF
            t_min = t_f if t_f < t_ev else t_ev
            if ai < n_arr and arr_t[ai] <= t_min:
                # batch-drain consecutive arrivals: arrivals are already
                # time-sorted so they never touch the heaps; the only way
                # the next-event bound can move is an arrival arming an
                # *earlier* sched tick, which the armed-heap head tracks
                while True:
                    t = arr_t[ai]
                    self._now = t
                    jid = jid0 + ai
                    req = JobRequest(jid, jid, t, arr_gpus[ai], arr_dur[ai],
                                     arr_prio[ai], outs[arr_out[ai]])
                    req.remaining_s = req.duration_s
                    ai += 1
                    enqueue(t, req)
                    if ai >= n_arr:
                        win = next(windows, None)
                        if win is None:
                            n_arr = 0
                            ai = 0
                            self._arr_next = jid + 1   # stream exhausted
                            break
                        (arr_t, arr_gpus, arr_dur, arr_prio, arr_out,
                         jid0) = win
                        n_arr = len(arr_t)
                        ai = 0
                    if armed and armed[0] < t_min:
                        t_min = armed[0]
                    if arr_t[ai] > t_min:
                        # snapshot cursor: consistent at every batch exit
                        # (hooks never fire mid-batch), two stores per
                        # batch instead of one per arrival
                        self._arr_next = jid0 + ai
                        break
                continue
            if t_min > horizon:   # also covers both-heaps-empty (inf)
                break
            if t_f < t_ev:
                t, node_id, gen = heappop(fheap)
                if gen != chain_gen[node_id]:
                    continue   # stale entry: chain re-armed at repair
                self._now = t
                if node_state[node_id] == N_DOWN:
                    # retire the chain: the node is out of service; the
                    # repair path arms a fresh generation (the v1 engine
                    # kept sampling faults here AND armed a fresh chain
                    # on repair — the compounding chain leak)
                    continue
                fault = sample_fault(node_id, t)
                self._handle_fault(t, fault)
                if policy is not None:
                    policy.on_fault(self, t, fault)
                continue
            # batch-drain the event heap: keep popping while the event
            # head stays ahead of the fault head (ties -> event) and the
            # next arrival (ties -> arrival) and inside the horizon; only
            # a K_REPAIR can push the fault head, so everything else
            # drains without re-peeking the other streams
            while True:
                t, seq, kind, payload = heappop(events)
                self._now = t
                if kind == K_FINISH:
                    r = running.get(payload)
                    if r is None or r.finish_seq != seq:
                        # cancelled/stale finish: fall through to re-check
                        pass
                    else:
                        run_ = r.run
                        ran = t - r.start_t
                        run_.productive_s += ran
                        rem = run_.remaining_s - ran
                        if rem < 0.0:
                            rem = 0.0
                        run_.remaining_s = rem
                        state = state_of[run_.outcome] if rem <= 1.0 \
                            else _TIMEOUT
                        self._record(r, t, state)
                        self._end_job(r, t)
                elif kind == K_SCHED:
                    if armed and armed[0] <= t:
                        heappop(armed)
                    # _pass_t absorbs same-tick re-arms from in-pass
                    # preemption releases: the changed/blocked retry logic
                    # below covers them.  Set before the policy hook: the
                    # pass's K_SCHED/armed entries are already popped, so
                    # a snapshot from inside the hook would lose the pass
                    # (the snapshot guard keys off _pass_t).
                    self._pass_t = t
                    if policy is not None:
                        # interventions (evictions, spare releases) land
                        # before the pass so this tick's placements see them
                        policy.on_schedule_pass(self, t)
                    if on_sched_pass is None and obs_sched_pass is None:
                        n_started, n_preempted, blocked = \
                            self._schedule_pass(t)
                    elif obs_sched_pass is None:
                        n_queued = len(self.queue) + len(self._deferred)
                        n_started, n_preempted, blocked = \
                            self._schedule_pass(t)
                        on_sched_pass(t, n_queued, n_started, n_preempted,
                                      blocked)
                    else:
                        n_queued = len(self.queue) + len(self._deferred)
                        obs_pass_i += 1
                        if obs_pass_i >= OBS_PASS_SAMPLE:
                            obs_pass_i = 0
                            w0 = perf_counter()
                            n_started, n_preempted, blocked = \
                                self._schedule_pass(t)
                            pass_wall = perf_counter() - w0
                        else:
                            n_started, n_preempted, blocked = \
                                self._schedule_pass(t)
                            pass_wall = -1.0
                        if on_sched_pass is not None:
                            on_sched_pass(t, n_queued, n_started,
                                          n_preempted, blocked)
                        obs_sched_pass(t, n_queued, n_started, n_preempted,
                                       blocked, pass_wall)
                    self._pass_t = -1.0
                    if self.queue or self._deferred:
                        if n_started > 0 or n_preempted > 0:
                            # progress was made but jobs remain: continue at
                            # the next tick (backfill depth / capacity may
                            # now allow more placements)
                            self._arm_sched(t + SCHED_TICK_S)
                        elif blocked:
                            # blocked purely on the 2 h preemption guard:
                            # retry when the earliest victim is eligible
                            expiry = self._next_guard_expiry(t)
                            if expiry < _INF:
                                self._arm_sched(expiry)
                elif kind == K_REPAIR:
                    node_id = payload
                    if policy is not None:
                        act = policy.on_node_repair(self, t, node_id)
                        if act == POLICY_HOLD:
                            # policy keeps the node (warm spare pool);
                            # record the hold so node-state sequences in
                            # the trace stay reconstructable
                            if self.recorder is not None:
                                self.recorder.on_node_event(
                                    t, node_id, "hold", "policy")
                            break   # fault head may be stale: re-peek
                        if act:    # health gate: delay return-to-service
                            self._push(t + float(act), K_REPAIR, node_id)
                            break
                    self._return_to_service(t, node_id)
                    break   # pushed a fault chain: fault head changed
                elif kind == K_KILL:
                    self._handle_kill(t, payload)
                elif kind == K_DETECT:
                    self._handle_detect(t, payload)
                elif kind == K_DOMFAULT:
                    self._handle_domain_fault(t, payload)
                elif kind == K_LEMON:
                    self._lemon_scan(t)
                elif kind == K_POLICY:
                    if policy is not None:
                        policy.on_timer(self, t, payload)
                if not events:
                    break
                t_ev = events[0][0]
                if t_ev > t_f or t_ev > horizon:
                    break
                if ai < n_arr and arr_t[ai] <= t_ev:
                    break

        # close out still-running jobs as CANCELLED at horizon (censored)
        for r in list(self.running.values()):
            self._record(r, self.horizon_s, _CANCELLED)
