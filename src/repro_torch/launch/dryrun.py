"""Multi-node dry run: trace every (arch x shape) cell's step on the
production meshes and record its memory, FLOPs, bytes, collectives and
roofline (after ``repro.launch.dryrun``).

There is no XLA compile to ask.  One step is run once under
``FakeTensorMode`` (tensors that hold no data) on a ``"fake"`` process
group of 256 ranks (``single``: 16 x 16) or 512 (``multi``: 2 x 16 x 16),
as rank 0 of ``launch.mesh.make_mesh_named``'s DeviceMesh: the arguments
are DTensors placed by ``launch.specs``, the step the port's own, the
kernels their fake route.  ``launch.trace_analysis`` counts rank 0's ops
and ``MemTracker`` its peak memory.  Training doubles its microbatches
until the peak fits 0.97 of the card's HBM, as the reference does.

A decode step is traced at position seq_len - 1 (the cache full); its
scalar ``pos`` must be a Python int to the port's step.

The fake process group is the process's default group: run the CLI in a
process of its own (the tests do), never beside another group.

Usage (``--device cpu`` traces fake CPU tensors, on a machine without a
card):
  python -m repro_torch.launch.dryrun --arch granite-20b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun --resume
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, ShapeSpec, get_arch
from repro_torch.launch import hw, roofline, specs
from repro_torch.launch.mesh import device_count_required, make_mesh_named
from repro_torch.launch.trace_analysis import TraceCounter
from repro_torch.models import steps
from repro_torch.optim import adamw
from repro_torch.parallel.axes import mesh_context

ASSIGNED = [
    "granite-20b", "qwen3-0.6b", "starcoder2-3b", "gemma3-4b",
    "seamless-m4t-large-v2", "recurrentgemma-9b", "rwkv6-7b",
    "llama4-scout-17b-a16e", "mixtral-8x22b", "llava-next-34b",
]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
FIT = 0.97  # of HBM a step may take


def cell_id(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}__{shape}__{mesh}"


def fake_world(n: int) -> None:
    """Make the default process group a fake one of ``n`` ranks, this
    process rank 0 (once per size)."""
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def parse_overrides(cfg, overrides: dict):
    """Split ``--set`` overrides into (cfg, rule overrides, force_micro):
    ArchConfig fields are applied by ``cfg.replace``; ``rule:<logical
    axis>=<mesh dim|none|a,b>`` override the rules; ``env:<NAME>=<value>``
    set the environment."""
    overrides = dict(overrides)
    force_micro = int(overrides.pop("force_micro", 0))
    rule_over, cfg_over = {}, {}
    for k, v in overrides.items():
        if k.startswith("rule:"):
            ax = k.split(":", 1)[1]
            rule_over[ax] = (None if v in ("none", "None", "") else
                             tuple(v.split(",")) if "," in v else v)
        elif k.startswith("env:"):
            os.environ[k.split(":", 1)[1]] = str(v)
        else:
            field_type = type(getattr(cfg, k))
            cfg_over[k] = (field_type(v) if field_type is not bool
                           else str(v).lower() in ("1", "true", "yes"))
    return (cfg.replace(**cfg_over) if cfg_over else cfg), rule_over, force_micro


def _place(tree, pl, mesh):
    """Fake global tensors -> DTensors on ``mesh`` (each rank's shard)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: _place(tree[k], pl[k], mesh) for k in tree}
    if isinstance(tree, adamw.AdamWState):
        return adamw.AdamWState(step=tree.step, m=_place(tree.m, pl.m, mesh),
                                v=_place(tree.v, pl.v, mesh))
    if isinstance(tree, (list, tuple)):
        return [_place(t, p, mesh) for t, p in zip(tree, pl)]
    return distribute_tensor(tree, mesh, pl, src_data_rank=None)


def _local(tree) -> list:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _local(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _local(v)]
    return [tree.to_local() if isinstance(tree, DTensor) else tree]


def step_fn(cfg, shape: ShapeSpec, n_micro: int):
    """The cell's step over ``input_specs``' arguments."""
    if shape.kind == "train":
        # params and moments donated, as the reference's jit donates them
        return steps.make_train_step(cfg, adamw.AdamWConfig(), n_microbatches=n_micro,
                                     donate=True)
    prefill, decode = steps.make_serve_steps(cfg)
    if shape.kind == "prefill":
        return prefill
    return lambda params, cache, tokens: decode(params, dict(cache, pos=shape.seq_len - 1),
                                                tokens)


def trace(cfg, shape: ShapeSpec, mesh, rules, in_pl, *, n_micro: int = 1, device: str = "cuda",
          pod_size: int = hw.CHIPS_PER_POD) -> dict:
    """One traced step of the cell: {"peak", "argument_bytes", "trace_s",
    the ``TraceCounter`` summary}."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = _place(specs.input_specs(cfg, shape, device), in_pl, mesh)
        local = _local(args)
        mt = MemTracker()
        mt.track_external(*local)
        counter = TraceCounter(pod_size=pod_size)
        with mesh_context(mesh, rules), mt, counter:
            step_fn(cfg, shape, n_micro)(*args)
        peak = max(v["Total"] for v in mt.get_tracker_snapshot("peak").values())
    return dict(counter.summary(), peak=int(peak), trace_s=time.time() - t0,
                argument_bytes=int(sum(t.numel() * t.element_size() for t in local)))


def run_cell(arch_name: str, shape_name: str, mesh_name: str, overrides: dict | None = None,
             *, device: str = "cuda") -> dict:
    """Trace one cell; ``overrides`` as ``parse_overrides`` takes them."""
    overrides = dict(overrides or {})
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    rec: dict = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "status": "ok",
        "overrides": {k: str(v) for k, v in overrides.items()},
    }
    if shape_name == "long_500k" and not cfg.long_context_ok:
        rec["status"] = "skipped_full_attention"
        rec["note"] = ("pure full-attention arch: 524k decode is not "
                       "sub-quadratic-servable (see DESIGN.md)")
        return rec
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: trace fake CPU tensors with --device cpu")
    cfg, rule_over, force_micro = parse_overrides(cfg, overrides)
    fake_world(device_count_required(mesh_name))
    mesh = make_mesh_named(mesh_name, device_type=device)
    n_devices = mesh.size()
    rules = specs.rules_for(shape)
    if rule_over:
        rules = rules.with_overrides(**rule_over)
    dropped: list = []
    in_pl = specs.input_shardings(cfg, shape, mesh, rules, dropped)
    names = list(mesh.mesh_dim_names)
    dp = n_devices // (mesh.size(names.index("model")) if "model" in names else 1)

    # auto-fit: double the microbatches of a training step until it fits
    attempts = []
    n_micro = force_micro or 1
    while True:
        t = trace(cfg, shape, mesh, rules, in_pl, n_micro=n_micro, device=device)
        attempts.append({"n_microbatches": n_micro, "peak_device_bytes": t["peak"],
                         "trace_s": round(t["trace_s"], 2)})
        fits = t["peak"] <= FIT * hw.HBM_BYTES
        nxt = n_micro * 2
        if fits or force_micro or not (shape.kind == "train"
                                        and shape.global_batch % (nxt * dp) == 0):
            break
        n_micro = nxt
    coll = t["collectives"]
    rl = roofline.analyze(cfg, shape, n_devices=n_devices, flops_per_device=t["flops"],
                          bytes_per_device=t["bytes"],
                          intra_pod_coll_bytes=coll["intra_pod_bytes"],
                          cross_pod_coll_bytes=coll["cross_pod_bytes"])
    rec.update(
        n_devices=n_devices,
        n_microbatches=n_micro,
        fit_attempts=attempts,
        fits_hbm=bool(fits),
        trace_s=round(t["trace_s"], 2),
        memory={"argument_bytes": t["argument_bytes"], "peak_device_bytes": t["peak"]},
        cost={"flops_per_device": t["flops"], "bytes_per_device": t["bytes"],
              "aten_flops": t["aten_flops"], "aten_bytes": t["aten_bytes"],
              "kernel_flops": t["kernel_flops"], "kernel_bytes": t["kernel_bytes"],
              "kernel_calls": t["kernel_calls"]},
        collectives=dict(coll, pod_size=hw.CHIPS_PER_POD),
        roofline=rl.to_dict(),
        sharding_fallbacks=sorted({f"{ax}->{a} (dim={d})" for ax, a, d in dropped}),
        params_total=cfg.param_count(),
        params_active=cfg.active_param_count(),
    )
    return rec


def summarize(outdir: pathlib.Path) -> str:
    """The records under ``outdir`` as a markdown table, one row an (arch x
    shape) and its two meshes side by side: status, microbatches, peak GiB
    a rank, fits, dominant term, roofline fraction, trace seconds."""
    recs = {}
    for path in sorted(outdir.glob("*.json")):
        rec = json.loads(path.read_text())
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec

    def cell(rec):
        if rec is None:
            return "—"
        if rec["status"] != "ok":
            return rec["status"]
        rl = rec["roofline"]
        return (f"{rec['n_microbatches']} · {rec['memory']['peak_device_bytes'] / 2**30:.2f} · "
                f"{'yes' if rec['fits_hbm'] else 'no'} · {rl['dominant']} · "
                f"{rl['roofline_fraction']:.4f} · {rec['trace_s']}")

    lines = ["| arch | shape | single: micro · peak GiB · fits · dominant · fraction · trace_s "
             "| multi: the same |", "|---|---|---|---|"]
    for arch in ASSIGNED:
        for shape in SHAPE_NAMES:
            row = [recs.get((arch, shape, m)) for m in ("single", "multi")]
            if any(row):
                lines.append(f"| {arch} | {shape} | {cell(row[0])} | {cell(row[1])} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=SHAPE_NAMES + [None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the fake tensors (cpu: on a machine without a card)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override (cfg field, rule:<axis>, env:<var>, force_micro)")
    ap.add_argument("--tag", default=None,
                    help="variant tag; results land in <out>/<cell>__<tag>.json")
    ap.add_argument("--summarize", action="store_true",
                    help="print the records under --out as a markdown table and exit")
    args = ap.parse_args(argv)
    if args.summarize:
        print(summarize(pathlib.Path(args.out)))
        return
    overrides = dict(kv.split("=", 1) for kv in args.overrides)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = SHAPE_NAMES if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                cid = cell_id(arch, shape, mesh_name)
                if args.tag:
                    cid = f"{cid}__{args.tag}"
                path = outdir / f"{cid}.json"
                if args.resume and path.exists():
                    print(f"[skip] {cid} (exists)")
                    continue
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, mesh_name, overrides, device=args.device)
                except Exception as e:  # noqa: BLE001 -- record and continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    n_fail += 1
                path.write_text(json.dumps(rec, indent=1))
                extra = ""
                if rec["status"] == "ok":
                    rl = rec["roofline"]
                    extra = (f" dom={rl['dominant']} frac={rl['roofline_fraction']:.3f}"
                             f" mem={rec['memory']['peak_device_bytes'] / 2**30:.2f}GiB"
                             f" micro={rec['n_microbatches']} trace={rec['trace_s']}s")
                print(f"[{rec['status']}] {cid}{extra} ({time.time() - t0:.0f}s)", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
