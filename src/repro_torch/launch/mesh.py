"""Meshes: shapes for resolving the sharding rules, and live ones.

:func:`make_production_mesh` and :func:`make_mesh_for` return
shape-only meshes (:class:`~repro_torch.models.mesh_ctx.MeshShape`), so
the rules of ``launch/sharding.py`` resolve for 512 devices with no
process. :func:`init_mesh` brings up a live mesh on this rank over
``torch.distributed`` (one process per rank), and :func:`spawn` runs a
function on every rank of a world of processes on this host.

A mesh may carry a leading group axis that no ``MeshCtx`` collective
names (:data:`PD_AXES`: rank group 0 of ``pd`` prefills, group 1
decodes): each group's ``MeshCtx`` then runs on its own ``data`` ×
``model`` ranks, and a KV tree crosses between the groups over that
axis (``xccl.pd_transfer.KVLayout``).
"""
from __future__ import annotations

import os
import pickle
import socket
import tempfile
from typing import Any, Callable, Optional, Sequence

from repro_torch.models.mesh_ctx import Comm, MeshShape

AXES = ("data", "model")
#: disaggregated prefill-decode on one mesh: the rank groups, then AXES
PD_AXES = ("pd",) + AXES


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 chips per pod; 2×16×16 = 512 chips for two pods."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), AXES)


def make_mesh_for(n_devices: int, model_parallel: int = 1) -> MeshShape:
    """``(n_devices // model_parallel, model_parallel)`` over (data,
    model), ``model_parallel`` clipped to [1, n_devices]."""
    model_parallel = max(1, min(model_parallel, n_devices))
    return MeshShape((n_devices // model_parallel, model_parallel), AXES)


def init_mesh(shape: Sequence[int], backend: str, device: str, *,
              axis_names: Sequence[str] = AXES, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              init_method: Optional[str] = None) -> MeshShape:
    """A live mesh of ``shape`` on this rank: the default process group
    (``init_process_group(backend)``, unless one exists) and this rank's
    :class:`Comm`, which makes the process group of an axis, or of a
    tuple of axes ranked in the tuple's order as ``jax.lax`` ranks them,
    on first use.
    ``backend`` is ``"nccl"`` when each rank has its own card, ``"gloo"``
    otherwise (ranks on the CPU, or sharing one card: gloo then moves
    their tensors through host memory). ``device`` is where the rank
    computes (``"cpu"`` or ``"cuda"``); a rank that finds no card for
    ``"cuda"`` raises."""
    import torch
    import torch.distributed as dist

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_mesh: no CUDA device on this rank")
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError("init_mesh: NCCL needs device 'cuda'")
    n = 1
    for s in shape:
        n *= int(s)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            rank=int(os.environ.get("RANK", 0)) if rank is None else rank,
            world_size=n if world_size is None else world_size)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the world "
                         f"has {dist.get_world_size()}")
    comm = Comm(dict(zip(axis_names, shape)), dist.get_rank(), backend)
    return MeshShape(shape, axis_names, comm=comm)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world_size: int, port: int, out_dir: str,
               threads: int, args: tuple) -> None:
    import torch

    torch.set_num_threads(threads)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world_size))
    try:
        result = fn(rank, world_size, f"tcp://127.0.0.1:{port}", *args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable[..., Any], world_size: int, *args,
          threads: int = 1) -> list:
    """Run ``fn(rank, world_size, init_method, *args)`` in
    ``world_size`` fresh processes (spawned, not forked) and return the
    ranks' results in rank order. ``fn`` must be importable by name (a
    module-level function) and its result picklable; it calls
    :func:`init_mesh` with the ``init_method`` it is given; each rank
    uses ``threads`` CPU threads. A rank that raises fails the call
    with its exception."""
    import torch.multiprocessing as mp

    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, port, out_dir, threads, args),
            nprocs=world_size, join=False, start_method="spawn")
        while not ctx.join():
            pass
        out = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
