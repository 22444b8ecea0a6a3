"""Multi-host (multi-process) initialization.

Single-host multi-chip sharding is implemented and dry-run tested
(parallel/sweep.py, parallel/database.py).  Scaling the files axis across
*hosts* needs only process-group initialization — the mesh/sharding code is
process-count agnostic because every sharded array is placed with
``jax.device_put(…, NamedSharding(mesh, P("files")))`` and queries are pure
SPMD with replicated templates (all cross-chip traffic is the tiny top-k
gather, riding NVLink within a host and the network across hosts).

Smoke-tested with two local processes joining a ``jax.distributed`` group
over localhost (4 virtual CPU devices each → an 8-device global mesh,
sharded query answered SPMD): tests/test_multihost.py.  A real multi-host
transport has not been exercised.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["initialize", "global_files_mesh"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, **kwargs) -> None:
    """Join the JAX process group (no-op when single-process).

    Arguments default to the standard ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` environment variables; with
    neither arguments nor variables the call is a no-op.

    Extra keyword arguments pass through to
    ``jax.distributed.initialize`` — most usefully
    ``initialization_timeout`` (seconds): a worker that never arrives
    (crashed before joining, wrong address) then surfaces as a CLEAN
    timeout error on every waiting process instead of JAX's long default
    wait (failure-surface test: tests/test_multihost.py).  Per-process
    device counts may differ — the ``files`` mesh is built from
    ``jax.devices()``, whatever each host contributes.
    """
    import jax

    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None
                or "JAX_COORDINATOR_ADDRESS" in os.environ
                or "JAX_NUM_PROCESSES" in os.environ)
    if not explicit:
        return                      # plain single-process run
    if num_processes is None:
        env_np = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env_np) if env_np else None
    if num_processes == 1 and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id, **kwargs)


def global_files_mesh():
    """1-D ``files`` mesh over every device in the job (all hosts)."""
    from .sweep import make_files_mesh
    import jax

    return make_files_mesh(jax.devices())
