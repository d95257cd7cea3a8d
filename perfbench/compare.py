"""The comparison that decides a training cell's ``correct``.

Both sides give the same readings over the first checked steps from the
seed's weights (``reference.train.run`` and the harness's reading of the
program): each step's loss, each leaf's gradient at step 1 as the
optimizer takes it (clipped), and each leaf's change from its initial
value after the last checked step, the last two by their norms and their
sketches.  These numbers compare them:

- ``loss_gap``: the largest gap between the two sides' loss at a step, in
  nats;
- ``grad_gap``: over the leaves, the largest gap between the two sides'
  gradient norms, over the reference's norm of that leaf or of the median
  leaf, whichever is larger (some gradients are all but zero);
- ``update_gap``: the same of the change norms, over the leaves whose
  reference gradient is at least ``MOVED`` of the median leaf's: a leaf
  whose gradient is nought to rounding moves under Adam by round-off
  alone;
- ``grad_err``: over the leaves, the gap between the two sides' step-1
  gradients themselves, |g_prog - g_ref|, over the same denominator as
  ``grad_gap``.  It is estimated from each leaf's sketch
  (``weights.sketch``: dot products with random directions drawn from the
  seed, the same on both sides), so a gradient of the right norm but the
  wrong direction reads about 1.4, where ``grad_gap`` reads 0;
- ``update_err``: the same of each leaf's change after the last checked
  step, over the leaves ``update_gap`` takes;
- ``route_gap`` (MoE): the largest gap, in router probability, by which
  the experts the program chose lie below the reference's own k-th best
  (``reference.train``: the reference follows the program's routes and
  judges them).

A number that is not finite fails its limit.
"""
from __future__ import annotations

import math
import statistics

MOVED = 1e-3  # a leaf whose reference gradient norm is below this share of the median leaf's


def _sketch_gap(a: list, b: list) -> float:
    """|x - y| estimated from the sketches of x and y."""
    return math.sqrt(statistics.fmean((p - q) ** 2 for p, q in zip(a, b, strict=True)))


def _norm_gap(a: float, b: float) -> float:
    return abs(a - b)


# number: (the gap of a leaf's two readings, the readings, the reference's
# norms that scale them, whether only the moved leaves count)
LEAF_NUMBERS = {
    "grad_gap": (_norm_gap, "grad_norm", "grad_norm", False),
    "update_gap": (_norm_gap, "update_norm", "update_norm", True),
    "grad_err": (_sketch_gap, "grad_sketch", "grad_norm", False),
    "update_err": (_sketch_gap, "update_sketch", "update_norm", True),
}


def leaf_gaps(prog: dict, ref: dict, number: str) -> dict:
    """{leaf: its gap} of one of LEAF_NUMBERS: the gap between the two
    sides' readings over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    gap, key, scale, moved_only = LEAF_NUMBERS[number]
    norms = ref[scale]
    floor = statistics.median(norms.values())
    skip = set(unmoved(ref)) if moved_only else set()
    return {k: gap(prog[key][k], ref[key][k]) / max(norms[k], floor, 1e-30)
            for k in norms if k not in skip}


def numbers(prog: dict, ref: dict) -> dict:
    """{name: value} of the numbers between two sets of readings."""
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError(f"{len(prog['loss'])} program steps against {len(ref['loss'])}")
    if set(prog["grad_norm"]) != set(ref["grad_norm"]):
        raise ValueError("the two sides read different leaves")
    out = {"loss_gap": max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"]))}
    out.update({n: max(leaf_gaps(prog, ref, n).values()) for n in LEAF_NUMBERS})
    if "route_gap" in ref:
        out["route_gap"] = ref["route_gap"]
    return out


def unmoved(ref: dict) -> list:
    """The leaves whose reference gradient norm is under MOVED of the
    median leaf's."""
    floor = statistics.median(ref["grad_norm"].values())
    return sorted(k for k, g in ref["grad_norm"].items() if g < MOVED * floor)


def worst_leaves(prog: dict, ref: dict) -> dict:
    """The leaf that sets each number of the leaves."""
    out = {}
    for n in LEAF_NUMBERS:
        gaps = leaf_gaps(prog, ref, n)
        out[n] = max(gaps, key=gaps.get)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    if set(values) != set(limits):
        raise ValueError(f"numbers {sorted(values)} against limits {sorted(limits)}")
    checks = {k: {"value": values[k], "limit": limits[k]} for k in sorted(values)}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in values.items())
    return ok, checks
