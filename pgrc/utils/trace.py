"""Sub-stage wall-time tracing, enabled by PGRC_TRACE=1.

Prints `[trace] <label>: <dt>s` lines from the hot paths (sweep segments,
matcher passes, encoder host tails) — the observability layer behind the
per-stage stage_times (reference per-phase log timings, utils/helper.cpp:
33-47)."""
from __future__ import annotations

import os
import time

_ON = bool(os.environ.get("PGRC_TRACE"))


def enabled() -> bool:
    return _ON


class span:
    """with span("label"): ... — prints elapsed time when tracing is on."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if _ON:
            print(f"[trace] {self.label}: {time.time() - self.t0:.3f}s",
                  flush=True)
        return False
