"""Multi-host process-group setup (SURVEY P4 / §5 "distributed comm
backend"): the reference fans out with fork/exec + MOD/MATCH env sharding
(ref: iispt.cpp:479-505, tools/multiprocess_reference.py); here one
`jax.distributed.initialize` process group spans the hosts, after which
`jax.devices()` lists every GPU of every host and the existing
mesh/shard_map code paths scale unchanged (XLA routes the collectives).

Launch pattern (one process per host; nothing is auto-detected, so all
three values are required):
    PBRT_COORDINATOR=host0:8476 PBRT_NUM_PROCESSES=4 PBRT_PROCESS_ID=$i \
        python -m pbrt_v3_iile_tpu.cli.main scene.pbrt out.exr --multihost
"""

from __future__ import annotations

import os


_INITIALIZED = False


def maybe_initialize(coordinator: str = None, num_processes: int = None,
                     process_id: int = None) -> bool:
    """Initialize the cross-host process group.  Arguments fall back to
    PBRT_COORDINATOR / PBRT_NUM_PROCESSES / PBRT_PROCESS_ID.  Returns
    True when a multi-process group is active; safe to call repeatedly
    and a no-op for single-process runs with no configuration."""
    global _INITIALIZED
    import jax

    if _INITIALIZED:
        return jax.process_count() > 1

    coordinator = coordinator or os.environ.get("PBRT_COORDINATOR")
    if num_processes is None and os.environ.get("PBRT_NUM_PROCESSES"):
        num_processes = int(os.environ["PBRT_NUM_PROCESSES"])
    if process_id is None and os.environ.get("PBRT_PROCESS_ID"):
        process_id = int(os.environ["PBRT_PROCESS_ID"])

    if coordinator is None and num_processes is None:
        # nothing configured: single-process
        _INITIALIZED = True
        return False

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    _INITIALIZED = True
    return jax.process_count() > 1


def process_info() -> dict:
    import jax

    return dict(process_index=jax.process_index(),
                process_count=jax.process_count(),
                local_devices=len(jax.local_devices()),
                global_devices=len(jax.devices()))
