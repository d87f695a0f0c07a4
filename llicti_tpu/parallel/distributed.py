"""Multi-host initialization helpers.

For a multi-process run, call :func:`initialize` once per process,
before building meshes, with the coordinator's address, the process
count and this process's id; `jax.devices()` then becomes the global
device list.  Without a coordinator it is a no-op (single process).
"""
from __future__ import annotations

from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when running multi-process.

    Returns True when distributed mode is active.  With no coordinator
    this is a single-process no-op; with one, any failure to join the
    job propagates (a requested multi-process run never silently becomes
    a single-process one).  Re-entry after a successful initialize is a
    no-op.
    """
    if coordinator_address is None:
        return False
    # Do NOT probe jax.process_count() first: it initializes the local
    # backend, after which distributed.initialize refuses to run.
    if not jax.distributed.is_initialized():
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_count() > 1


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch owned by this process (even split)."""
    n = jax.process_count()
    i = jax.process_index()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)
