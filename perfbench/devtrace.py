"""The device trace of a traced run: torch.profiler over whole training
steps, read from its Chrome trace.

``device_profile`` is a frozen copy of the port's ``chip_smoke.device_profile``:
torch.profiler's traces lose device records from their start once a
process has run for a while, so the work runs twice in one trace under
``schedule(warmup=1, active=1)``, each call bracketed by two marker kernels
(``torch.cuda._sleep``), and a trace that lacks either marker of the kept
call is taken again, up to PROFILE_ATTEMPTS in all, then it raises.

The traced window is the device's time from the end of the first marker to
the start of the second; ``busy_s`` is the union of the device operations'
intervals inside it (kernels, copies and sets), so overlapping kernels
count once.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile

PROFILE_ATTEMPTS = 8
MARKER, MARKER_CYCLES = "spin_kernel", 1000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10  # entries of each list of the breakdown


def device_profile(fn):
    """(the kept call's trace events, what that call returned, the traces
    taken)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    marks = 0
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                torch.cuda._sleep(MARKER_CYCLES)
                out = fn()
                torch.cuda._sleep(MARKER_CYCLES)
                torch.cuda.synchronize()
                prof.step()
        events = _chrome_events(prof)
        marks = sum(1 for e in events if e.get("cat") == "kernel" and MARKER in e["name"])
        if marks == 2:
            return events, out, attempt
    raise RuntimeError(f"torch.profiler lost device records in {PROFILE_ATTEMPTS} traces "
                       f"in a row (the traced call's markers: {marks} of 2)")


def _chrome_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return json.loads(pathlib.Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)


class Window:
    """The device's operations between the two markers of a trace."""

    def __init__(self, events: list):
        marks = sorted((e for e in events if e.get("cat") == "kernel" and MARKER in e["name"]),
                       key=lambda e: e["ts"])
        if len(marks) != 2:
            raise ValueError(f"a traced window needs 2 markers, the trace has {len(marks)}")
        self.start = marks[0]["ts"] + marks[0]["dur"]
        self.end = marks[1]["ts"]
        self.ops = sorted(((e["name"], e["ts"], e["dur"]) for e in events
                           if e.get("cat") in DEVICE_CATS and MARKER not in e["name"]
                           and self.start <= e["ts"] < self.end), key=lambda op: op[1])
        self.host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                     and not e["name"].startswith("ProfilerStep")]
        self.busy, self.gaps = self._union()

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy / 1e6

    def _union(self) -> tuple[float, list]:
        busy, gaps, cursor = 0.0, [], self.start
        for _, ts, dur in self.ops:
            end = min(ts + dur, self.end)
            if ts > cursor:
                gaps.append((cursor, ts))
            if end > cursor:
                busy += end - max(ts, cursor)
                cursor = end
        if self.end > cursor:
            gaps.append((cursor, self.end))
        return busy, gaps

    def op_seconds(self, pattern) -> float:
        """Device seconds of the operations whose name ``pattern`` (a
        compiled regex) finds."""
        return sum(dur for name, _, dur in self.ops if pattern.search(name)) / 1e6

    def device_ops(self) -> list:
        """The TOP device operations by their summed time: [[name, s]]."""
        total: dict = {}
        for name, _, dur in self.ops:
            total[name] = total.get(name, 0.0) + dur / 1e6
        return [[n[:160], s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:TOP]]

    def idle_gaps(self, longest: int = 200) -> list:
        """The idle time of the ``longest`` gaps, summed by the innermost host
        operation that was running at each gap's middle: [[name, s]]."""
        by_name: dict = {}
        for lo, hi in sorted(self.gaps, key=lambda g: g[0] - g[1])[:longest]:
            mid = (lo + hi) / 2
            inner = [e for e in self.host if e["ts"] <= mid < e["ts"] + e["dur"]]
            name = max(inner, key=lambda e: e["ts"])["name"][:160] if inner else "(no host op)"
            by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e6
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:TOP]]
