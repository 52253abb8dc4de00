"""Multi-host serving over the data-center network (SURVEY.md §5
'distributed communication backend': the reference's only cross-node
awareness is etcd registration; its compute is single-process. Here each
HOST runs one server process and registers itself in etcd — clients
load-balance across hosts (go-micro style) — while JAX's distributed runtime
links the hosts' devices into one global device set).

Topology stance (scaling-book recipe): data parallel ACROSS hosts — every
window/stream is independent, so requests never cross the host network —
and tensor parallel only WITHIN a host's directly linked devices (make_mesh's
tp axis).
There is nothing like pipeline/sequence parallelism to place: whisper's
sequence length is capped at 1500 encoder frames (SURVEY.md §5
'long-context').

Configuration is env-driven (no-op when unset, so single-host deployments
pay nothing):
  SPEAKSENSE_COORDINATOR   host:port of process 0
  SPEAKSENSE_NUM_PROCESSES total host count
  SPEAKSENSE_PROCESS_ID    this host's index (0-based)
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed from args or environment. Returns True if
    a multi-process runtime was started; False for the single-host no-op."""
    coordinator = coordinator or os.environ.get("SPEAKSENSE_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("SPEAKSENSE_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid = os.environ.get("SPEAKSENSE_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator or not num_processes or num_processes <= 1:
        return False
    import jax

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    log.info("jax.distributed up: process %s of %s (coordinator %s)",
             process_id, num_processes, coordinator)
    return True


def local_serving_mesh(tp: int = 1):
    """Per-host (dp, tp) mesh over THIS process's addressable devices.

    Serving is data-parallel across hosts (each host owns its own request
    stream), so the mesh spans local devices only; tp shards the model over
    the host's directly linked devices. Use parallel.make_mesh directly for a
    global mesh (e.g. training-style SPMD over all hosts).
    """
    import jax

    from speaksense_tpu.parallel.mesh import make_mesh

    return make_mesh(devices=jax.local_devices(), tp=tp)
