"""Device-trace reader: the card's kernels from a ``torch.profiler``
trace (the port's counterpart of ``mxnet_tpu/xplane.py``).

``torch.profiler`` (Kineto over CUPTI) exports a Chrome-trace JSON
document whose ``traceEvents`` hold the host's ops and, for a CUDA
activity, one complete ``"X"`` event for each device event: kernels
(``cat`` ``kernel``), copies (``gpu_memcpy``) and memsets
(``gpu_memset``), with ``dur`` in microseconds.  This module turns the
device events into the reference's per-op table,
``{name: {count, total_us, avg_us}}``.

A profiler cycle (``profiler.start`` to ``stop``) writes one file for
each stretch between ``pause``/``resume`` into its trace directory,
named ``<cycle>-<segment>.pt.trace.json``; a directory is read as the
newest cycle's files together.  A file cut short (a writer that died,
a copy still in flight) yields the events that parsed before the cut;
a directory with no trace gives ``{}`` and ``device_total_ms`` gives
None, as the reference's reader does.
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

__all__ = ["DEVICE_CATEGORIES", "read_events", "cycle_files",
           "device_events", "device_op_table", "device_total_ms",
           "format_table"]

# the Chrome-trace categories of events that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SUFFIX = ".pt.trace.json"


def read_events(path: str) -> List[dict]:
    """The ``traceEvents`` of one trace file; of a file cut short, the
    events that parsed before the cut; ``[]`` for an unreadable one."""
    try:
        with open(path, "rb") as f:
            text = f.read().decode("utf-8", "replace")
    except OSError:
        return []
    try:
        doc = json.loads(text)
    except ValueError:
        return _events_before_cut(text)
    if isinstance(doc, dict):
        evs = doc.get("traceEvents")
    else:
        evs = doc
    return [e for e in evs or () if isinstance(e, dict)]


def _events_before_cut(text: str) -> List[dict]:
    """Decode the events of ``traceEvents`` one at a time until the text
    ends or stops parsing."""
    key = text.find('"traceEvents"')
    start = text.find("[", key) if key >= 0 else text.find("[")
    if start < 0:
        return []
    dec = json.JSONDecoder()
    out: List[dict] = []
    i, n = start + 1, len(text)
    while i < n:
        while i < n and text[i] in " \t\r\n,":
            i += 1
        if i >= n or text[i] == "]":
            break
        try:
            ev, i = dec.raw_decode(text, i)
        except ValueError:
            break
        if isinstance(ev, dict):
            out.append(ev)
    return out


def cycle_files(trace_dir: str) -> List[str]:
    """The newest cycle's trace files in ``trace_dir``, in segment order
    (``[]`` when there is none)."""
    files = glob.glob(os.path.join(trace_dir, "*" + SUFFIX))
    if not files:
        return []
    groups: Dict[str, List[str]] = defaultdict(list)
    for f in files:
        stem = os.path.basename(f)[:-len(SUFFIX)]
        groups[stem.rsplit("-", 1)[0]].append(f)
    newest = max(groups.values(),
                 key=lambda fs: max(os.path.getmtime(f) for f in fs))

    def seg(f):
        tail = os.path.basename(f)[:-len(SUFFIX)].rsplit("-", 1)[-1]
        return int(tail) if tail.isdigit() else 0
    return sorted(newest, key=seg)


def device_events(trace_dir_or_file: str) -> List[dict]:
    """The device events (kernels, copies, memsets) of a trace file, or
    of the newest cycle in a trace directory."""
    path = trace_dir_or_file
    files = cycle_files(path) if os.path.isdir(path) else [path]
    out = []
    for f in files:
        out += [e for e in read_events(f)
                if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    return out


def device_op_table(trace_dir_or_file: str) -> Dict[str, Dict[str, float]]:
    """``{name: {"count": n, "total_us": t, "avg_us": a}}`` over the
    device events of a trace.  Totals add every stream's events, so
    kernels that overlap on two streams can sum past the wall time."""
    table: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "total_us": 0.0})
    for ev in device_events(trace_dir_or_file):
        try:
            dur = float(ev.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        row = table[str(ev.get("name", "?"))]
        row["count"] += 1
        row["total_us"] += dur
    return {name: {"count": r["count"], "total_us": r["total_us"],
                   "avg_us": r["total_us"] / max(r["count"], 1)}
            for name, r in table.items()}


def device_total_ms(trace_dir_or_file: str) -> Optional[float]:
    """Total device-event ms of a trace, or None when it has no usable
    device events (no trace, a file with none, a non-positive total)."""
    try:
        table = device_op_table(trace_dir_or_file)
    except Exception:
        return None
    total_us = sum(r["total_us"] for r in table.values())
    if not table or total_us <= 0:
        return None
    return total_us / 1e3


def format_table(table: Dict[str, Dict[str, float]], limit: int = 40,
                 title: str = "Device op statistics") -> str:
    lines = [title + ":",
             f"{'Name':<52}{'Count':>8}{'Total(us)':>14}{'Avg(us)':>12}"]
    rows = sorted(table.items(), key=lambda kv: -kv[1]["total_us"])
    for name, row in rows[:limit]:
        nm = name if len(name) <= 50 else name[:47] + "..."
        lines.append(f"{nm:<52}{row['count']:>8}"
                     f"{row['total_us']:>14.1f}{row['avg_us']:>12.1f}")
    total = sum(r["total_us"] for _, r in rows)
    lines.append(f"{'TOTAL':<52}{'':>8}{total:>14.1f}")
    return "\n".join(lines)
