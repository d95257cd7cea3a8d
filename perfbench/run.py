"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration and its
traffic (files found by name under ``perfbench/``) and the metrics it
reports; ``perfbench/workloads/<cell>.json`` holds its limits.  With
``--trace 0`` the line carries the end-to-end metrics, with ``--trace 1``
the per-layer ones.  The run needs one CUDA device and the port
(``src/repro_torch``) beside this folder; it exits with a code other than
0 and prints no result without them, if anything of JAX or the JAX
package is loaded once the window has closed, or if a traced run finds
nothing to read for a per-layer metric the cell lists.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Python's bytecode of everything the run imports (torch, the port, this
# folder) is cached inside the checkout at a fixed path, beside the port's
# nvcc build, so that only a checkout's first run compiles it: an
# installation shipped without bytecode, in an environment that forbids
# writing it (PYTHONDONTWRITEBYTECODE), otherwise compiles torch anew in
# every run, seconds of CPU time that swing with the host's load.
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False
# the repository's root and the port's source, not this folder, on the path
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
# cuBLAS is deterministic for training only when this is set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ.setdefault("USE_FLAX", "0")


def host_line() -> str:
    """The card's name, power limit and clocks, the host's CPUs and
    MemAvailable."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    mem = dict(line.split(":", 1) for line in
               pathlib.Path("/proc/meminfo").read_text().splitlines() if ":" in line)
    avail = int(mem["MemAvailable"].split()[0]) / 2**20
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else "?"
    return f"card: {card}; host: {os.cpu_count()} CPUs, MemAvailable {avail:.1f} GiB"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    cell, _, _ = harness.cell_files(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  torch.device("cuda", 0), t_start=T_START)
    except harness.MissingReading as e:
        print(e, file=sys.stderr)
        return 4
    bad = harness.loaded_forbidden(sys.modules)
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    line = host_line()
    print(line)
    harness.log(line)
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
