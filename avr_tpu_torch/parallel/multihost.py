"""The multi-process runtime (port of ``avr_tpu/parallel/multihost.py``).

One process per device, joined by ``torch.distributed``:

* :func:`initialize` joins the process group from a launcher's environment
  (``python -m torch.distributed.run``: ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from explicit
  arguments;
* per-process data: ``SceneClassDataset(shard_index=process_index(),
  num_shards=process_count())`` strides instances across processes;
* the sharded train step (``parallel/sharded_step.py``) runs on every rank
  and all-reduces the gradients;
* :func:`gather_metrics` averages host scalars across processes for
  logging, and :func:`assemble_eval_image` gathers a rays-sharded render
  onto every process.

The backend follows the device unless the caller names it: NCCL for CUDA,
gloo for the CPU (:func:`backend_for`).  Nothing switches it quietly.
Host-bound collectives (:func:`gather_metrics`, :func:`assemble_eval_image`)
run on the card under NCCL and on the host under gloo (:func:`comm_device`).

Single-process runs are no-ops throughout, so the same training script
works from one device to many.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from avr_tpu_torch.utils.device import resolve_device

__all__ = [
    "initialize",
    "launched",
    "backend_for",
    "comm_device",
    "process_index",
    "process_count",
    "is_primary",
    "barrier",
    "gather_metrics",
    "assemble_eval_image",
]

LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


def launched() -> bool:
    """Whether a launcher (``torch.distributed.run``) started this process."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def backend_for(device: Union[str, torch.device]) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device: Union[str, torch.device, None] = None,
               timeout_s: Optional[float] = None) -> None:
    """Join the process group (a no-op when single-process or already joined).

    ``init_method`` (default ``env://``), ``world_size`` and ``rank`` are
    ``torch.distributed.init_process_group``'s; unset, the launcher's
    environment gives them.  ``backend`` defaults to :func:`backend_for`
    ``(device)``, and ``device`` to the card (the CPU when asked); under NCCL each process takes the card
    ``LOCAL_RANK`` (default: its rank modulo the cards it sees).

    Fail-loud contract (JAX's): when a multi-process job was *requested* (an
    explicit ``world_size > 1``, an explicit ``init_method``, or a
    launcher's or ``MASTER_ADDR`` environment) any failure raises.
    Proceeding single-process there would train N independent models while
    logging normally.  Only the bare call with no cluster configuration
    anywhere stays single-process, and an explicit ``world_size <= 1``
    returns at once."""
    if _grouped():
        return
    if world_size is not None and world_size <= 1:
        return
    requested = ((world_size is not None and world_size > 1) or init_method is not None
                 or launched() or "MASTER_ADDR" in os.environ)
    if not requested:
        return
    if backend is None:
        backend = backend_for(resolve_device(device))
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kw)
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())


def comm_device() -> torch.device:
    """Where host-bound collectives keep their tensors: the current card
    under NCCL, the host otherwise."""
    if _grouped() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_index() -> int:
    return dist.get_rank() if _grouped() else 0


def process_count() -> int:
    return dist.get_world_size() if _grouped() else 1


def is_primary() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Wait for every process (a no-op single-process)."""
    if _grouped():
        dist.barrier()


def gather_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """Mean of host-local scalar metrics across processes (float64: equal
    values average to themselves)."""
    vals = {k: float(v) for k, v in metrics.items()}
    if process_count() == 1:
        return vals
    keys = sorted(vals)
    t = torch.tensor([vals[k] for k in keys], dtype=torch.float64, device=comm_device())
    dist.all_reduce(t)
    t = (t / process_count()).cpu()
    return {k: float(t[i]) for i, k in enumerate(keys)}


def assemble_eval_image(block, mesh=None) -> np.ndarray:
    """A rays-sharded render, whole, on every process, as numpy.

    ``block`` is this rank's ``(SB / D, R / R_mesh, ...)`` block of a render
    laid out over ``mesh`` (``parallel/mesh.py``); the blocks are
    all-gathered and put back in mesh order.  Without a mesh or a process
    group the block is the whole image."""
    if isinstance(block, np.ndarray):
        block = torch.from_numpy(block)
    if mesh is None or not mesh.grouped:
        return block.detach().cpu().numpy()
    t = block.detach().to(comm_device()).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t)
    R = mesh.shape[mesh.axis_names[1]]
    rows = [torch.cat(parts[i:i + R], dim=1) for i in range(0, mesh.size, R)]
    return torch.cat(rows, dim=0).cpu().numpy()
