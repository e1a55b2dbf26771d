"""Multi-process (multi-GPU, multi-host) bootstrap of the sharded
Monte-Carlo (port of ``mimo_ofdm_tpu/parallel/multihost.py``).

The reference's "distributed runtime" is N OS processes on one machine
racing on lock-protected shared BER counters
(``reference/main_mp_clipping_noise_cancellation/main_mp_miso_cnc_ber_vs_ebn0.py:119-132``,
``reference/mp_model.py:89-99``). Here ``torch.distributed`` joins one
process per device into a process group, the ``(dp, tp)`` mesh spans its
ranks, and the per-round ``all_reduce`` over ``dp`` replaces the shared
counter (NVLink within a host, the network across hosts, under NCCL).

* Every process runs the same host loop on the same (replicated) counter
  values, so the stop criterion (:mod:`mimo_ofdm_tpu_torch.parallel.montecarlo`)
  needs no change and no other host-to-host traffic.
* Every rank draws a round's global frames from ``round_seed(key, idx)``,
  so the summed counters are identical for any process count or mesh that
  keeps the global batch and ``tp = 1``.
* Runs on CUDA devices (NCCL) and on CPU processes (gloo) for testing.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from mimo_ofdm_tpu_torch.parallel.sharded import make_mesh, make_sharded_round_fn
from mimo_ofdm_tpu_torch.utils.config import LinkConfig

DEFAULT_TIMEOUT = timedelta(minutes=10)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, local_device_ids=None,
               backend: str | None = None,
               timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Join this process to the job's process group
    (``torch.distributed.init_process_group``). With ``coordinator_address``
    (``host:port`` of rank 0) the group rendezvouses at
    ``tcp://coordinator_address`` with the ``num_processes`` and
    ``process_id`` given; without it, at ``env://``, from the ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` that ``torchrun`` sets.

    ``backend`` defaults to ``nccl`` when there is a CUDA device, else
    ``gloo``. On a CUDA machine the process takes the device
    ``local_device_ids[0]``, else ``$LOCAL_RANK`` (modulo the devices
    present). A collective that waits longer than ``timeout`` fails the
    job rather than hanging it. Call once, before any other collective."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        local = (local_device_ids[0] if local_device_ids
                 else int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(local % torch.cuda.device_count())
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, timeout=timeout)


def global_mesh(n_tp: int = 1):
    """The ``(dp, tp)`` mesh over every rank of the job. ``dp`` spans hosts
    (one counter all-reduce a round); keep ``tp`` within a host, where
    each frame's antenna combines ride NVLink."""
    return make_mesh(n_tp=n_tp)


def make_multihost_round_fn(cfg: LinkConfig, n_iters: int, global_batch: int,
                            n_tp: int = 1, **kw):
    """The sharded round over every rank, and its mesh: ``global_batch``
    frames a round across the job, counters replicated on every process,
    so the caller's Monte-Carlo loop does not depend on the process count."""
    mesh = global_mesh(n_tp)
    return make_sharded_round_fn(cfg, n_iters, global_batch, mesh, **kw), mesh


def process_info() -> dict:
    """Topology summary for logs and JSON evidence: this rank, the number
    of ranks, the devices this host has, and the job's device count (one
    device per rank)."""
    initialized = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": dist.get_world_size() if initialized else 1,
        "local_device_count": torch.cuda.device_count() if torch.cuda.is_available() else 1,
        "global_device_count": dist.get_world_size() if initialized else 1,
        "backend": dist.get_backend() if initialized else None,
    }
