"""Reader of torch.profiler Chrome traces (the port's counterpart of
tpu_audio/utils/xplane.py, which reads jax.profiler's .xplane.pb).

``torch.profiler.profile(...).export_chrome_trace(path)`` writes a JSON
object whose ``traceEvents`` list holds one complete event (``"ph": "X"``)
per recorded span: its category (``cat``: ``kernel``, ``gpu_memcpy``,
``gpu_memset``, ``cuda_runtime``, ``cuda_driver``, ``cpu_op``,
``python_function``, ``user_annotation``, ...), its ``name`` and its
duration ``dur`` in microseconds. The hand-written kernels, launched
through ctypes, appear under ``kernel`` by their CUDA names, as CUPTI sees
every launch on the device.
"""

from __future__ import annotations

import glob
import json
import os

TRACE_SUFFIX = ".pt.trace.json"


def newest_trace(directory: str | os.PathLike) -> str | None:
    """The most recently written ``*.pt.trace.json`` under `directory`
    (searched recursively), or None."""
    found = glob.glob(os.path.join(os.fspath(directory), "**",
                                   "*" + TRACE_SUFFIX), recursive=True)
    return max(found, key=os.path.getmtime) if found else None


def category_events(path: str | os.PathLike) -> dict[str, dict[str, list]]:
    """{category: {event name: [duration in microseconds, ...]}} of every
    complete event in the trace at `path`."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    out: dict[str, dict[str, list]] = {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat") or "uncategorized"
        out.setdefault(cat, {}).setdefault(ev.get("name", ""), []).append(
            float(ev["dur"]))
    return out
