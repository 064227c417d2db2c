"""Per-stage render statistics (the stats.h:279 counter + stats.cpp:207
profiler role, wavefront-style).

Two mechanisms, mirroring the reference's pair:
1. Counters/stage wall-clock: a process-global registry filled by the
   host-side drivers.  Stage timing forces device sync, so it is gated
   behind enable() (CLI --stats / env PBRT_STATS=1) exactly like the
   reference's --stats flag gates PrintStats (pbrt.cpp Options.quiet).
2. Trace annotations: every wavefront stage in integrators/path.py runs
   under jax.named_scope, so a jax.profiler / xprof capture attributes
   device time to intersect/NEE/shade/RR without any host overhead.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

# enabled via enable() from the CLI --stats flag (cli/main.py) or by
# harness callers — no env-var side channel (SURVEY §5 config plan)
_ENABLED = False
_STAGES: dict = defaultdict(float)
_STAGE_CALLS: dict = defaultdict(int)
_COUNTERS: dict = defaultdict(int)


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def reset():
    _STAGES.clear()
    _STAGE_CALLS.clear()
    _COUNTERS.clear()


def add_counter(name: str, n):
    _COUNTERS[name] += int(n)


@contextmanager
def stage(name: str, sync=None):
    """Time a host-side stage; sync: optional array to block on so the
    measurement covers device work (only when stats are enabled —
    otherwise passes are free to pipeline)."""
    if not _ENABLED:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        if sync is not None:
            try:
                import jax
                jax.block_until_ready(sync)
            except Exception:
                pass
        _STAGES[name] += time.time() - t0
        _STAGE_CALLS[name] += 1


def timed(name: str, fn, *args, **kw):
    """Run fn and (when enabled) block + attribute its wall time."""
    if not _ENABLED:
        return fn(*args, **kw)
    t0 = time.time()
    out = fn(*args, **kw)
    try:
        import jax
        jax.block_until_ready(out)
    except Exception:
        pass
    _STAGES[name] += time.time() - t0
    _STAGE_CALLS[name] += 1
    return out


def report() -> str:
    """Render the stats table (ref: stats.cpp PrintStats layout)."""
    lines = ["Statistics:"]
    if _STAGES:
        total = sum(_STAGES.values())
        lines.append("  Stage wall time")
        for k in sorted(_STAGES, key=lambda k: -_STAGES[k]):
            dt = _STAGES[k]
            lines.append(
                f"    {k:<28s} {dt:9.3f} s  {100 * dt / max(total, 1e-12):5.1f} %"
                f"  ({_STAGE_CALLS[k]} calls)")
        lines.append(f"    {'TOTAL':<28s} {total:9.3f} s")
    if _COUNTERS:
        lines.append("  Counters")
        for k in sorted(_COUNTERS):
            lines.append(f"    {k:<36s} {_COUNTERS[k]:>14,d}")
    return "\n".join(lines)
