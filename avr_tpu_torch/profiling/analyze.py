"""Aggregate time by operation from a ``torch.profiler`` chrome trace (the
port's counterpart of ``avr_tpu/profiling/analyze.py``, which reads JAX's
xplane traces).

Usage (programmatic)::

    from avr_tpu_torch.profiling.analyze import busy_share, op_breakdown, print_breakdown
    rows = op_breakdown("/tmp/trace_dir")   # newest *.json(.gz) inside
    print_breakdown(rows, top=30)
    print(busy_share("/tmp/trace_dir"))

or from the command line::

    python -m avr_tpu_torch.profiling.analyze /tmp/trace_dir [top_k]

``--profile_dir`` of ``python -m avr_tpu_torch.cli.train`` writes such a
trace.  Rows sum the device lane's events (``kernel``, ``gpu_memcpy``,
``gpu_memset``) by name, in microseconds, with their counts.  A trace with no
device lane (a CPU run) gives the CPU operators' self time instead (each
operator's time less that of the operators it called, so nothing counts
twice).  :func:`busy_share` is the share of the trace's window (first event
to last) in which at least one device event ran.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["load_events", "op_breakdown", "busy_share", "print_breakdown"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
Row = Tuple[str, float, int]


def _find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    cands = sorted((p for pat in ("*.json", "*.json.gz")
                    for p in glob.glob(os.path.join(path, "**", pat), recursive=True)),
                   key=os.path.getmtime)
    if not cands:
        raise FileNotFoundError(f"no chrome trace (*.json, *.json.gz) under {path}")
    return cands[-1]


def load_events(path: str) -> List[dict]:
    """The complete (``"ph": "X"``) events of the newest trace under ``path``
    (or of the file ``path``)."""
    f = _find_trace(path)
    opener = gzip.open if f.endswith(".gz") else open
    with opener(f, "rt") as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _cpu_self_times(events: List[dict]) -> List[Tuple[str, float]]:
    """``(name, self us)`` of each CPU operator: its duration less its
    direct children's, thread by thread."""
    out = []
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op":
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[list] = []  # [event, children's us]
        for e in evs:
            while stack and e["ts"] >= stack[-1][0]["ts"] + stack[-1][0]["dur"]:
                done, child_us = stack.pop()
                out.append((done["name"], done["dur"] - child_us))
            if stack:
                stack[-1][1] += e["dur"]
            stack.append([e, 0.0])
        out.extend((done["name"], done["dur"] - child_us) for done, child_us in stack)
    return out


def op_breakdown(path: str) -> List[Row]:
    """``[(name, total us, count), ...]`` sorted by time, largest first: the
    device events by name, or the CPU operators' self times when the trace
    has no device event."""
    events = load_events(path)
    device = [(e["name"], float(e["dur"])) for e in events if e.get("cat") in DEVICE_CATS]
    pairs = device or _cpu_self_times(events)
    totals: Dict[str, float] = collections.defaultdict(float)
    counts: Dict[str, int] = collections.defaultdict(int)
    for name, us in pairs:
        totals[name] += us
        counts[name] += 1
    return sorted(((k, v, counts[k]) for k, v in totals.items()), key=lambda r: -r[1])


def busy_share(path: str) -> Dict[str, Optional[float]]:
    """The trace window (first event's start to last event's end, us), the
    time in it when a device event ran (overlaps counted once) and its
    share; ``busy_us`` and ``share`` are ``None`` for a trace with no device
    lane."""
    events = [e for e in load_events(path) if e.get("cat") != "Trace"]
    if not events:
        raise ValueError(f"{path}: the trace has no events")
    t0 = min(e["ts"] for e in events)
    window = max(e["ts"] + e["dur"] for e in events) - t0
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS)
    if not spans:
        return dict(window_us=window, busy_us=None, share=None, device_events=0)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return dict(window_us=window, busy_us=busy, share=busy / window if window else None,
                device_events=len(spans))


def print_breakdown(rows: List[Row], top: int = 30) -> None:
    total = sum(r[1] for r in rows)
    print(f"{'op':60s} {'us':>12s} {'%':>6s} {'count':>8s}")
    for name, us, n in rows[:top]:
        print(f"{name[:60]:60s} {us:12.1f} {100 * us / max(total, 1e-9):6.2f} {n:8d}")
    print(f"{'TOTAL':60s} {total:12.1f}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit("usage: python -m avr_tpu_torch.profiling.analyze TRACE_DIR [top_k]")
    path = argv[0]
    top = int(argv[1]) if len(argv) > 1 else 30
    print_breakdown(op_breakdown(path), top=top)
    b = busy_share(path)
    if b["busy_us"] is None:
        print(f"window {b['window_us']:.1f} us; no device lane (a CPU trace: CPU self times)")
    else:
        print(f"window {b['window_us']:.1f} us; device busy {b['busy_us']:.1f} us "
              f"({b['share']:.4f} of the window, {b['device_events']} device events)")


if __name__ == "__main__":
    main()
