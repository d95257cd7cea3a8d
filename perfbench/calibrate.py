"""Readings that set a cell's limits, on the chip at the cell's own size:
for each seed the comparison's numbers of the sound program, of the
control (the reference in float8, ``reference.train.FP8``, and the port's
own 8-bit AdamW state) and of the planted faults (``harness.FAULTS``;
``noop_step`` is not run but read from the sound run with every leaf's
gradient and change set to 0, which is what it leaves), each against the
f32 reference of that seed.  One JSON line a (seed,
variant) goes to standard output and to ``--out``.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --variant-seeds 3 --out <file>

The first ``--variant-seeds`` seeds run every variant, the others the
sound program alone.  No window is measured.
"""
import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

PROGRAM_VARIANTS = {"sound": {}, "opt8bit": {"opt8bit": True},
                    "half_batch": {"fault": "half_batch"},
                    "leaf_unmoved": {"fault": "leaf_unmoved"}}


def _emit(out, row: dict) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def readings(name, seed, device, cfg=None, traffic=None, variant_seeds=True, out=None):
    """{variant: numbers} of one seed.  An MoE model's f32 reference follows
    each variant's own routes, so it runs once a variant; the sound
    program's is also read against a reference that routes on its own
    ("sound_own_routes"), which shows what following the routes takes out."""
    import torch

    from perfbench import compare, harness, weights
    from perfbench.reference import train as reference

    _, cell_cfg, cell_traffic = harness.cell_files(name)
    cfg, traffic = cfg or cell_cfg, traffic or cell_traffic
    B, S, n = traffic["batch"], traffic["seq_len"], traffic["check_steps"]
    n_mb = traffic["n_microbatches"]
    pool = weights.token_pool(cfg["vocab_size"], n, B, S, seed)
    sides = {}
    for variant, kw in PROGRAM_VARIANTS.items():
        if variant != "sound" and not variant_seeds:
            continue
        t0 = time.perf_counter()
        program = harness.Program(cfg, traffic, seed, device, **kw)
        sides[variant] = harness.checked_steps(program, pool, n, n_mb)
        program.free()
        del program
        sides[variant]["seconds"] = time.perf_counter() - t0
    if variant_seeds:
        t0 = time.perf_counter()
        sides["fp8"] = reference.run(cfg, seed, pool, device, "fp8", n_microbatches=n_mb)
        sides["fp8"]["seconds"] = time.perf_counter() - t0
    refs = {}

    def ref_for(routes):
        key = id(routes)
        if key not in refs:
            t0 = time.perf_counter()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            r = reference.run(cfg, seed, pool, device, n_microbatches=n_mb, routes=routes)
            r["seconds"] = time.perf_counter() - t0
            if device.type == "cuda":
                r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            refs[key] = r
            _emit(out, {"cell": name, "seed": seed, "variant": "reference",
                        "seconds": r["seconds"], "peak_gib": r.get("peak_gib"),
                        "loss": r["loss"], "dropped": r.get("dropped"),
                        "flips": r.get("flips")})
        return refs[key]

    moe = bool(cfg.get("moe"))
    rows = {}
    checks = list(sides.items())
    if variant_seeds:
        # noop_step leaves every leaf where it was: its gradient and change
        # read 0 (the losses are the sound run's, so its loss_gap is not read)
        sound = sides["sound"]
        zero = {k: {name: 0.0 * x if not isinstance(x, list) else [0.0] * len(x)
                    for name, x in sound[k].items()}
                for k in ("grad_norm", "update_norm", "grad_sketch", "update_sketch")}
        checks.append(("noop_step", dict(sound, **zero)))
    if moe:
        checks.append(("sound_own_routes", dict(sides["sound"], routes=None)))
    for variant, side in checks:
        ref = ref_for(side.get("routes") if moe else None)
        rows[variant] = dict(compare.numbers(side, ref), worst=compare.worst_leaves(side, ref),
                             flips=ref.get("flips"), seconds=side["seconds"], loss=side["loss"])
        if variant == "sound_own_routes":
            rows[variant].pop("route_gap")
        if variant == "noop_step":
            rows[variant].pop("loss_gap")
        _emit(out, {"cell": name, "seed": seed, "variant": variant, **rows[variant]})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant-seeds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    from repro_torch.runtime.train_loop import require_deterministic

    require_deterministic()
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        readings(args.workload, seed, torch.device("cuda", 0),
                 variant_seeds=i < args.variant_seeds, out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
