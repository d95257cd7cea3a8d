"""One run of one training cell: set-up, the measured window, the traced
window (``--trace 1``), and the comparison with the reference.

What the window drives is the port's own train step,
``repro_torch.models.steps.make_train_step(cfg, optimizer, n_microbatches,
dtype=bfloat16, donate=True)``, the step ``FaultTolerantTrainer`` builds,
under the trainer's settings (deterministic cuBLAS and algorithms, f32
masters and AdamW moments, remat as the configuration states).  Each step
copies one host batch of the pool to the card and reads the loss once, as
the trainer's loop does.  The trainer itself is not run: it makes its own
weights and data, and saves a checkpoint at its last step.

Set-up makes the weights on the card and the token pool on the host from
the seed (``weights``), builds the step and its AdamW state, and drives
that same step through the first ``check_steps`` batches of the pool: they
warm up every shape the window runs, and they are the steps the reference
follows.  After them the harness reads each leaf's step-1 gradient from
the first moment and each leaf's change from its initial value, each by
its norm and its sketch; the window then continues the same params and
state.  Once the window (and
the traced steps) are over and the device's peak is read, the program's
state is freed and the reference runs the checked steps in f32 on the same
weights and batches (``reference.train``); ``compare`` decides ``correct``.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import pathlib
import statistics
import sys
import time
from typing import Optional

import torch

from perfbench import compare, devtrace, weights
from perfbench.reference import train as reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
TRACE_STEPS = 2                       # steps in the traced call
FAULTS = ("noop_step", "half_batch", "leaf_unmoved")
# The port's functions the benchmark wraps: the spans of the traced run
# (``repro_torch.models.steps.loss_and_grads``, and ``optim.adamw.apply``
# as ``make_train_step`` reads it when it builds the step) and the record of
# an MoE step's routes (``models.layers.top_k``).
WRAPPED = "steps.loss_and_grads, adamw.apply and layers.top_k"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # JAX and the JAX package


def loaded_forbidden(modules) -> list:
    """The FORBIDDEN packages among ``modules`` (names of loaded modules),
    compared by whole top-level names: ``repro_torch`` is not ``repro``."""
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of workload ``name``: the cell is its
    entry in ``BENCHMARK.json`` with the ``limits`` of
    ``workloads/<name>.json``; the configuration and the traffic it names
    are found by name under the benchmark's folder."""
    entry = [w for w in benchmark()["workloads"] if w["name"] == name]
    if not entry:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(entry[0], limits=load_json(HERE / "workloads" / f"{name}.json")["limits"])
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def metric_module(name: str):
    """The reader of per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, section: str, cell: str) -> list[dict]:
    """The entries of ``section`` a cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def arch_config(cfg: dict):
    """The port's ArchConfig of a configuration file."""
    from repro_torch.configs.base import ArchConfig, MoESpec

    return ArchConfig(
        name=cfg["name"], family=cfg["family"], n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"], n_kv_heads=cfg["n_kv_heads"],
        d_head=cfg["d_head"], d_ff=cfg["d_ff"], vocab_size=cfg["vocab_size"],
        block_groups=(((cfg["layer_kind"],), cfg["n_layers"]),), window=cfg["window"],
        rope_theta=cfg["rope_theta"], moe=MoESpec(**cfg["moe"]) if cfg["moe"] else None,
        tie_embeddings=cfg["tie_embeddings"], ffn_gated=cfg["ffn_gated"],
        norm_eps=cfg["norm_eps"], remat_policy=cfg["remat_policy"],
        loss_chunk=cfg["loss_chunk"], source=cfg["source"])


def check_leaves(cfg: dict, arch) -> None:
    """The benchmark's leaves are the port's: names, shapes, f32, init."""
    from repro_torch.models import params as pmod
    from repro_torch.models import transformer

    defs = dict(pmod.flatten(transformer.model_defs(arch)))
    mine = {leaf.name: leaf for leaf in weights.leaves(cfg)}
    if set(defs) != set(mine):
        raise RuntimeError(f"leaves differ from the port's: {sorted(set(defs) ^ set(mine))}")
    for name, d in defs.items():
        leaf = mine[name]
        std = d.init_scale / math.sqrt(max(d.shape[0] if len(d.shape) == 1
                                           else math.prod(d.shape[:-1]), 1))
        if (tuple(d.shape) != leaf.shape or d.dtype != torch.float32 or d.init != leaf.init
                or (d.init == "normal" and not math.isclose(std, leaf.std, rel_tol=1e-12))):
            raise RuntimeError(f"leaf {name}: the port declares {d}, the benchmark {leaf}")


class MissingReading(RuntimeError):
    """A per-layer metric listed for the cell found nothing to read: the
    traced run fails rather than leave it out."""


class Spans:
    """CUDA events around the calls of the port's functions it wraps, while
    ``on``."""

    def __init__(self):
        self.events: dict = {}
        self.on = False

    def wrap(self, name: str, fn):
        self.events[name] = []

        def wrapped(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events[name].append((start, end))
            return out
        return wrapped

    def ms(self, name: str) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events.get(name, [])]


def dequantized(m) -> torch.Tensor:
    """A moment leaf as f32: the 8-bit state's {"q", "s"} (int8 codes, an
    f32 scale a block of the last axis) or the f32 tensor itself."""
    if not isinstance(m, dict):
        return m
    q, s = m["q"], m["s"]
    blk = q.shape[-1] // s.shape[-1]
    return (q.reshape(*q.shape[:-1], -1, blk).float() * s[..., None]).reshape(q.shape)


class Program:
    """The port's train step with its params and AdamW state, made from the
    seed.  ``fault`` plants one of FAULTS under the step (for the checks of
    the comparison); ``opt8bit`` takes the port's 8-bit AdamW state."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, *,
                 fault: Optional[str] = None, opt8bit: bool = False,
                 spans: Optional[Spans] = None):
        from repro_torch.models import steps
        from repro_torch.optim import adamw

        self.cfg, self.seed, self.device = cfg, seed, device
        arch = arch_config(cfg)
        check_leaves(cfg, arch)
        self.opt = adamw.AdamWConfig(**cfg["optimizer"])
        n_mb = traffic["n_microbatches"]
        saved = (steps.loss_and_grads, adamw.apply, os.environ.get("REPRO_OPT8BIT"))
        try:
            if spans is not None:
                steps.loss_and_grads = spans.wrap("loss_and_grads", steps.loss_and_grads)
                adamw.apply = spans.wrap("apply", adamw.apply)
            os.environ["REPRO_OPT8BIT"] = "1" if opt8bit else "0"
            step = steps.make_train_step(arch, self.opt, n_microbatches=n_mb,
                                         dtype=torch.bfloat16, donate=True)
        finally:
            if saved[2] is None:
                os.environ.pop("REPRO_OPT8BIT")
            else:
                os.environ["REPRO_OPT8BIT"] = saved[2]
        self._restore = (steps, adamw, saved[0], saved[1]) if spans is not None else None
        self.params = weights.draw_all(cfg, seed, device)
        self.state = (adamw.init_8bit if step.opt8bit else adamw.init)(self.params)
        self.step_fn = _planted(step, fault, arch, n_mb)

    @contextlib.contextmanager
    def routes_taken(self):
        """Record the experts the port's MoE layers choose (each call of
        ``models.layers.top_k``) while inside; yields the list of calls."""
        from repro_torch.models import layers

        calls: list = []
        if not self.cfg.get("moe"):
            yield calls
            return
        top_k = layers.top_k

        def recorded(probs, k):
            idx = top_k(probs, k)
            calls.append(idx.detach().cpu())
            return idx
        layers.top_k = recorded
        try:
            yield calls
        finally:
            layers.top_k = top_k

    def step_routes(self, calls: list, n_mb: int) -> list:
        """One step's routes, one (groups, G, k) a layer, from its calls of
        ``top_k``: each microbatch routes its L layers forward and, under
        remat, again in the backward in reverse order, to the same
        experts."""
        L = self.cfg["n_layers"]
        per_mb = 2 * L if self.cfg["remat_policy"] != "none" else L
        if len(calls) != n_mb * per_mb:
            raise RuntimeError(f"{len(calls)} routings in a step, expected {n_mb * per_mb}")
        out = [[] for _ in range(L)]
        for m in range(n_mb):
            blk = calls[m * per_mb:(m + 1) * per_mb]
            for i in range(L):
                if per_mb == 2 * L and not torch.equal(blk[i], blk[2 * L - 1 - i]):
                    raise RuntimeError(f"layer {i}'s recompute routed otherwise")
                out[i].append(blk[i])
        return [torch.cat(r) for r in out]

    def step(self, host_batch: torch.Tensor) -> float:
        batch = {"tokens": host_batch.to(self.device, torch.long)}
        self.params, self.state, metrics = self.step_fn(self.params, self.state, batch)
        return float(metrics["loss"])  # waits for the step

    @torch.no_grad()
    def grad_readings(self) -> tuple[dict, dict]:
        """Each leaf's gradient as the optimizer took it at step 1, from the
        first moment after that step (m = (1 - b1) g): its norm and its
        sketch."""
        norms, sketches = {}, {}
        scale = 1.0 / (1.0 - self.opt.b1)
        for k, m in self.state.m.items():
            m = dequantized(m)
            norms[k] = reference.norm(m) * scale
            sketches[k] = [x * scale for x in weights.sketch(m, self.seed, "grad", k)]
        return norms, sketches

    @torch.no_grad()
    def update_readings(self) -> tuple[dict, dict]:
        """The norm and the sketch of each leaf's change from its initial
        value (drawn again from the seed)."""
        norms, sketches = {}, {}
        for leaf in weights.leaves(self.cfg):
            delta = self.params[leaf.name] - weights.draw(leaf, self.seed, self.device)
            norms[leaf.name] = reference.norm(delta)
            sketches[leaf.name] = weights.sketch(delta, self.seed, "update", leaf.name)
            del delta
        return norms, sketches

    def free(self) -> None:
        if self._restore is not None:
            steps, adamw, lag, apply = self._restore
            steps.loss_and_grads, adamw.apply = lag, apply
        self.params = self.state = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _planted(step, fault: Optional[str], arch, n_mb: int):
    """The step with ``fault`` planted under it: ``noop_step`` computes the
    loss and returns the params and state it was given; ``half_batch``
    takes the mean over the first half of the batch's rows; ``leaf_unmoved``
    writes the largest leaf back as it was before the update."""
    if fault is None:
        return step
    if fault == "noop_step":
        from repro_torch.models import steps

        def noop(p, s, b):
            loss, _, _ = steps.loss_and_grads(arch, p, b, n_microbatches=n_mb,
                                              dtype=torch.bfloat16)
            return p, s, {"loss": loss}
        return noop
    if fault == "half_batch":
        return lambda p, s, b: step(p, s, {k: x[: x.shape[0] // 2] for k, x in b.items()})
    if fault == "leaf_unmoved":
        def unmoved(p, s, b):
            name = max(p, key=lambda k: p[k].numel())
            before = p[name].clone()
            p, s, m = step(p, s, b)
            p[name].copy_(before)
            return p, s, m
        return unmoved
    raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")


def checked_steps(program: Program, pool: torch.Tensor, n: int, n_mb: int) -> dict:
    """Drive the program through the pool's first n batches; its readings,
    each step's wall, and for an MoE model the routes it took (one list of
    layers a step)."""
    losses, grad, routes, walls = [], {}, [], []
    for i in range(n):
        t0 = time.perf_counter()
        with program.routes_taken() as calls:
            losses.append(program.step(pool[i]))
        walls.append(time.perf_counter() - t0)
        if program.cfg.get("moe"):
            routes.append(program.step_routes(calls, n_mb))
        if i == 0:
            grad, grad_sketch = program.grad_readings()
    update, update_sketch = program.update_readings()
    out = {"loss": losses, "grad_norm": grad, "update_norm": update,
           "grad_sketch": grad_sketch, "update_sketch": update_sketch, "step_s": walls}
    if program.cfg.get("moe"):
        out["routes"] = routes
    return out


class TracedRun:
    """What the per-layer metrics read of a traced run."""

    def __init__(self, cfg, traffic, steps, wall_s, spans, window, trace_steps, peak):
        self.cfg, self.traffic = cfg, traffic
        self.step_s = wall_s / steps
        self.spans, self.trace, self.trace_steps = spans, window, trace_steps
        self.window_peak_bytes = peak

    def span_ms(self, name: str) -> Optional[float]:
        """The mean of the span's calls in the traced window; None where the
        port made no such call."""
        ms = self.spans.ms(name)
        return statistics.fmean(ms) if ms else None


def per_layer(bench: dict, name: str, run: TracedRun) -> dict:
    """The per-layer metrics cell ``name`` lists, read from a traced run;
    MissingReading where one finds nothing to read."""
    out = {}
    for m in metrics_of(bench, "per_layer", name):
        value = metric_module(m["name"]).read(run)
        if value is None:
            raise MissingReading(
                f"per-layer metric {m['name']} found nothing to read in cell {name}: "
                f"{WRAPPED} are wrapped by name, and the flash kernels found by the names "
                f"in metrics/flash_roofline.py")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: torch.device, *,
             t_start: float, cfg: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[dict] = None, fault: Optional[str] = None) -> dict:
    """One run of cell ``name``; the result line's object.  ``cfg``,
    ``traffic`` and ``limits`` replace the cell's own (tests run a small
    copy on the CPU), ``fault`` plants one of FAULTS."""
    bench = benchmark()
    cell, cell_cfg, cell_traffic = cell_files(name)
    cfg, traffic = cfg or cell_cfg, traffic or cell_traffic
    limits = limits or cell["limits"]
    cuda = device.type == "cuda"
    if cuda:
        from repro_torch.runtime.train_loop import require_deterministic

        require_deterministic()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, n_check = traffic["batch"], traffic["seq_len"], traffic["check_steps"]
    pool = weights.token_pool(cfg["vocab_size"], traffic["pool_batches"], B, S, seed)
    spans = Spans() if trace else None
    t_context, cpu_context = time.perf_counter(), time.process_time()
    torch.empty(0, device=device)  # the CUDA context
    t_program = time.perf_counter()
    program = Program(cfg, traffic, seed, device, fault=fault, spans=spans)
    n_mb = traffic["n_microbatches"]
    t_steps = time.perf_counter()
    readings = checked_steps(program, pool, n_check, n_mb)
    log(f"set-up: to the context {t_context - t_start:.2f} s (imports, the driver; "
        f"cpu {cpu_context:.2f} s), "
        f"context {t_program - t_context:.2f} s, "
        f"weights and state {t_steps - t_program:.2f} s, {n_check} checked steps "
        f"{', '.join(f'{s:.2f}' for s in readings['step_s'])} s and their readings "
        f"{time.perf_counter() - t_steps - sum(readings['step_s']):.2f} s; "
        f"load average {os.getloadavg()[0]:.2f}; losses {readings['loss']}")

    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        torch.cuda.reset_peak_memory_stats()
        spans.on = True
    setup_s = time.perf_counter() - t_start
    losses, ends, t0 = [], [], time.perf_counter()
    while True:
        losses.append(program.step(pool[(n_check + len(losses)) % len(pool)]))
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    wall = ends[-1] - t0
    steps = len(losses)
    walls = [b - a for a, b in zip([t0] + ends, ends)]
    log(f"window: {steps} steps in {wall:.4f} s; first step {walls[0]:.4f} s, "
        f"the others {min(walls[1:], default=0):.4f}-{max(walls[1:], default=0):.4f} s")
    result = {"correct": False, "attempted": steps,
              "failed": sum(1 for x in losses if not math.isfinite(x)), "metrics": {}}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1}
    if trace:
        spans.on = False
        window_peak = torch.cuda.max_memory_allocated()
        at = n_check + steps
        events, _, taken = devtrace.device_profile(
            lambda: [program.step(pool[(at + i) % len(pool)]) for i in range(TRACE_STEPS)])
        win = devtrace.Window(events)
        log(f"trace: {taken} trace(s) taken; window {win.window_s:.6f} s, busy {win.busy_s:.6f} s")
        run = TracedRun(cfg, traffic, steps, wall, spans, win, TRACE_STEPS, window_peak)
        result["metrics"] = per_layer(bench, name, run)
        device_info.update(busy_s=win.busy_s, window_s=win.window_s)
        result["breakdown"] = {"device_ops": win.device_ops(), "idle_gaps": win.idle_gaps()}
    else:
        for m in metrics_of(bench, "end_to_end", name):
            value = {"train_tokens_per_s": steps * B * S / wall, "setup_s": setup_s}[m["name"]]
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    if cuda:
        device_info["memory_peak_bytes"] = max(setup_peak, torch.cuda.max_memory_allocated())
    result["device"] = device_info
    program.free()
    del program

    t_ref = time.perf_counter()
    ref = reference.run(cfg, seed, pool[:n_check], device, n_microbatches=n_mb,
                        routes=readings.get("routes"))
    log(f"reference: {n_check} steps in {time.perf_counter() - t_ref:.1f} s, losses {ref['loss']}; "
        f"leaves left out of update_gap: {compare.unmoved(ref)}")
    ok, checks = compare.judge(compare.numbers(readings, ref), limits)
    result["correct"] = ok and result["failed"] == 0
    result["checks"] = checks
    return result
