"""Device mesh and process-group bring-up for data parallelism.

Counterpart of ``nf_tpu.parallel.mesh`` on ``torch.distributed``.  The
scaling axis of this workload is the sample batch, so the layout is a 1-D
``"dp"`` mesh over every rank: each rank maps a disjoint slice of the batch,
the flow's parameters are replicated, and the accumulators are all-reduced.
One process drives one device (a rank); NCCL carries the collectives
between cards and gloo between CPU processes.

A rank's slice of a global batch of ``n`` rows is the ``r``-th of ``W``
equal row blocks (:func:`shard_rows`), so the shards concatenated in rank
order are the global batch: the port's counterpart of
``NamedSharding(mesh, P("dp"))``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

AXIS = "dp"


def make_mesh(devices=None, axis_name: str = AXIS, device="cuda"):
    """A 1-D ``DeviceMesh`` named ``(axis_name,)`` over the ranks ``devices``
    (default: every rank of the process group, in rank order).  Its device
    type is ``"cuda"`` unless the caller asks for the CPU.  The process group
    must exist (:func:`initialize_distributed`)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call initialize_distributed first")
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to run on the CPU")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis_name,))


def group_of(mesh, axis_name: str = AXIS):
    """The process group of ``mesh``'s axis; ``None`` for ``mesh=None``."""
    return None if mesh is None else mesh.get_group(axis_name)


def rank_and_size(group):
    """``(rank, world size)`` within ``group``; ``(0, 1)`` for ``None``."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def local_rows(n: int, group, what: str = "n"):
    """The row range ``(start, stop)`` of this rank's shard of ``n`` rows;
    ``ValueError`` unless the world size divides ``n``."""
    rank, size = rank_and_size(group)
    if n % size:
        raise ValueError(f"{what}={n} not divisible by mesh size {size}")
    n_local = n // size
    return rank * n_local, (rank + 1) * n_local


def shard_rows(x: torch.Tensor, group):
    """This rank's row block of the global batch ``x``."""
    start, stop = local_rows(x.shape[0], group)
    return x[start:stop]


def data_parallel_sharding(mesh, axis_name: str = AXIS):
    """The batch sharding over ``mesh``: a slicer ``fn(x) -> x``'s row block
    of this rank (:func:`shard_rows`), the leading axis cut into equal
    blocks in rank order."""
    group = group_of(mesh, axis_name)

    def shard(x):
        return shard_rows(x, group)
    return shard


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           device="cuda", timeout=None):
    """Multi-process bring-up: ``init_process_group`` and a global mesh.

    Call once per process.  ``coordinator_address`` is ``"host:port"`` of
    rank 0; ``num_processes`` and ``process_id`` are the world size and this
    process's rank.  Left ``None``, they come from torchrun's environment
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as jax
    detects its cluster.  On ``device="cuda"`` the backend is NCCL and this
    process takes the card ``LOCAL_RANK`` (default: its rank modulo the
    cards present); on the CPU it is gloo.  ``timeout`` (seconds) bounds the
    rendezvous and every collective.  Returns :func:`make_mesh` over the
    world.
    """
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(env["RANK"] if process_id is None else process_id)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: no CUDA device; pass device='cpu'")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, **kw)
    return make_mesh(device=device)
