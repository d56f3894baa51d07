"""Multi-host entry points on ``torch.distributed`` (the port of
``spmv_tpu/parallel/multihost.py``).

Every process calls :func:`init_distributed`, builds the identical plan
from the same matrix (the builders are deterministic) on the mesh of
:func:`global_mesh_1d`, and places only the shards its rank owns
(``Mesh.ranks``, ``parallel/mesh.py``); the executors' collectives then
run between the ranks as ``torch.distributed`` calls.  Every rank passes
the whole x and gets the whole y.  One rank a process, as ``torchrun``
starts them::

    # torchrun --nproc-per-node 4 solve.py, where solve.py holds
    init_distributed()                  # NCCL, cuda:LOCAL_RANK
    mesh = global_mesh_1d()             # one shard a rank, in rank order
    plan = build_dist_auto(a, mesh)     # each rank places its shards
    y = plan(x)

NCCL carries CUDA tensors and refuses two ranks on one card; ranks that
share a card, or run on the CPU, take gloo (``backend="gloo"``), which
carries host copies.  Nothing switches from one backend to the other.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["init_distributed", "global_mesh_1d", "is_multiprocess"]


def _local_device(device) -> torch.device:
    """``device``, or ``cuda:LOCAL_RANK``; raises when CUDA is absent and
    the CPU was not asked for."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local)
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible; pass device='cpu' for "
                           "ranks on the host")
    return torch.device("cuda", local)


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> None:
    """Start the default process group (idempotent: once it is up, a call
    returns).

    With no arguments it reads the environment ``torchrun`` sets:
    MASTER_ADDR and MASTER_PORT (the ``env://`` rendezvous), WORLD_SIZE,
    RANK and LOCAL_RANK.  ``backend`` defaults from ``device``
    (``cuda:LOCAL_RANK`` by default): "nccl" for a CUDA device, "gloo" for
    ``device="cpu"``; ``backend="gloo"`` may be asked for on CUDA, and then
    ``device`` is only made current.  A backend that fails to start
    raises."""
    if dist.is_initialized():
        return
    dev = (None if backend == "gloo" and device is None
           else _local_device(device))
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=(world_size if world_size is not None
                    else int(os.environ["WORLD_SIZE"])),
        rank=rank if rank is not None else int(os.environ["RANK"]))


def is_multiprocess() -> bool:
    """Whether a process group of more than one rank is up."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def global_mesh_1d(axis: str = "rows", device=None,
                   local_shards: int = 1) -> Mesh:
    """A 1-D mesh over every rank's device, ordered by rank, then by local
    index, as the JAX package orders devices by (process, id): contiguous
    row blocks map to ranks, so the halo ring crosses between processes
    only at its block edges.

    ``device`` defaults to ``cuda:LOCAL_RANK``; ``local_shards`` repeats it
    as ``make_mesh_1d(n, device=...)`` does (a mesh wider than the cards,
    as the JAX tests force virtual devices a process).  Every rank passes
    the same ``local_shards``.  With no process group the mesh is one
    process's, driven by it alone."""
    dev = _local_device(device)
    if not dist.is_initialized():
        return Mesh(tuple([dev] * local_shards), axis)
    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, (str(dev), local_shards))
    if len({k for _d, k in views}) != 1:
        raise ValueError(f"ranks ask for different local_shards: {views}")
    return Mesh(tuple(torch.device(d) for d, k in views for _ in range(k)),
                axis, ranks=tuple(r for r, (_d, k) in enumerate(views)
                                  for _ in range(k)))
