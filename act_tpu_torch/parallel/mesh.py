"""Processes, ranks and devices of a data-parallel run.

Counterpart of ``act_tpu/parallel/mesh.py``. The JAX package builds a
``('data', 'model')`` mesh and lets ``jit`` insert the gradient reduction;
the port runs one process a card under ``torch.distributed`` (launched by
``python -m torch.distributed.run --nproc_per_node=N``) and follows the
mesh's one-program semantics by hand: a step over R ranks with b clouds
each computes what one process computes on the R*b clouds of the global
batch (``train_state._update`` averages the gradients,
``models.common.BatchNorm`` takes global statistics, and every draw of a
step is taken over the global batch with ``rand_local``).

``shard_batch``, ``shard_stacked`` and ``replicate`` have no counterpart
here: each rank's loader already holds its own rows of the global batch
(``datasets/loader.py``), and the parameters start equal on every rank
(``broadcast_module``). Without a process group every function below is
the one-process identity.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

_CPU_GROUP = None  # the gloo group of host-side collectives, made on first use


def is_distributed() -> bool:
    """True once a default process group exists (even of world size 1)."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main_process() -> bool:
    return process_index() == 0


def initialize_distributed(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), as the
    JAX package joins ``JAX_COORDINATOR_ADDRESS`` (``mesh.py:91-99``). The
    backend is ``nccl`` for a CUDA ``device``, ``gloo`` for the CPU. Without
    those variables, or with a group already made, it does nothing. Returns
    whether a group exists afterwards."""
    if is_distributed():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local_device(device)
    dist.init_process_group(backend=backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    cpu_group()
    return True


def destroy_distributed() -> None:
    """Leave the process group, if there is one."""
    global _CPU_GROUP
    if is_distributed():
        dist.destroy_process_group()
    _CPU_GROUP = None


def local_device(device="cuda") -> torch.device:
    """``device`` resolved (``ops.resolve_device``); under torchrun a bare
    ``"cuda"`` is ``cuda:LOCAL_RANK``. A CUDA device becomes the current one.
    Raises if ``LOCAL_RANK`` names no card (it never wraps around the count)."""
    from act_tpu_torch.ops._backend import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None and "LOCAL_RANK" in os.environ:
        local, count = int(os.environ["LOCAL_RANK"]), torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(f"LOCAL_RANK {local} but this host has {count} CUDA devices")
        dev = torch.device("cuda", local)
    if dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def cpu_group():
    """The group for host-side collectives (numpy arrays, python scalars,
    the preemption flag): the default group under gloo, else a gloo group
    over the same ranks, made once (every rank makes it at the same call)."""
    global _CPU_GROUP
    if not is_distributed():
        return None
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if _CPU_GROUP is None:
        _CPU_GROUP = dist.new_group(backend="gloo")
    return _CPU_GROUP


def barrier() -> None:
    """Wait for every rank (on the host group: no device sync)."""
    if is_distributed():
        dist.barrier(group=cpu_group())


def rand_local(shape: Sequence[int], generator: torch.Generator, dim: int = 0,
               dtype: Optional[torch.dtype] = None, device=None,
               draw: Optional[Callable] = None) -> torch.Tensor:
    """This rank's rows of a draw over the global batch: ``shape`` is the
    local shape, ``dim`` its batch axis. Over R ranks every rank draws the
    global shape (R times the rows along ``dim``) from ``generator`` and
    keeps rows ``[r*b, (r+1)*b)``, so the generators of all ranks stay in
    step and the R-rank step draws what the one-process step draws on the
    concatenated batch. One process draws ``shape`` itself, as before.
    ``draw(shape)`` replaces ``torch.rand`` (e.g. a ``torch.randint``);
    ``device`` defaults to the generator's."""
    if draw is None:
        def draw(s):
            return torch.rand(s, generator=generator, device=device or generator.device,
                              dtype=dtype)
    shape = tuple(int(s) for s in shape)
    R = process_count()
    if R == 1:
        return draw(shape)
    b = shape[dim]
    full = draw(shape[:dim] + (b * R,) + shape[dim + 1:])
    return full.narrow(dim, process_index() * b, b)


def randint_local(high: int, shape: Sequence[int], generator: torch.Generator,
                  dim: int = 0) -> torch.Tensor:
    """``rand_local`` of ``torch.randint(0, high, ...)``."""
    return rand_local(shape, generator, dim, draw=lambda s: torch.randint(
        0, high, s, generator=generator, device=generator.device))
