"""Processes, ranks and devices, and their (data, model) grid.

Counterpart of ``act_tpu/parallel/mesh.py``. The JAX package builds a
``('data', 'model')`` mesh and lets ``jit`` insert the collectives; the
port runs one process a card under ``torch.distributed`` (launched by
``python -m torch.distributed.run --nproc_per_node=N``) and follows the
mesh's one-program semantics by hand. ``initialize_model_parallel(T)``
lays the R ranks out as ``make_mesh(model_parallel=T)`` lays out devices,
``reshape(R // T, T)``: rank r is data index ``r // T`` and model index
``r % T``. The T ranks of a model group hold the same rows of the global
batch and one shard each of the tensor-parallel weights
(``parallel/tp.py``); the R / T ranks of a data group hold the same shard
and different rows. A step over D = R / T data indices with b clouds each
computes what one process computes on the D*b clouds of the global batch
(``train_state._update`` averages the gradients over the data group,
``models.common.BatchNorm`` takes the data group's statistics, and every
draw of a step is taken over the global batch with ``rand_local``, so
model peers draw alike). Without a grid, or at T = 1, the data index and
count are the process index and count.

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
_GRID = None  # the (data, model) grid of initialize_model_parallel at T > 1


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
    """Leave the process group (and its grid), if there is one."""
    global _CPU_GROUP, _GRID
    if is_distributed():
        dist.destroy_process_group()
    _CPU_GROUP = _GRID = None


def initialize_model_parallel(model_parallel: int) -> None:
    """Lay the ranks out as a (data, model) grid of ``model_parallel`` = T
    ranks a model group (``make_mesh(model_parallel=T)``, ``mesh.py:23-28``):
    rank r is data index ``r // T`` and model index ``r % T``. Every rank
    calls it once, after ``initialize_distributed``; it makes the data
    groups, then the model groups (every rank makes every group, in the same
    order), each with a gloo twin for host collectives under another backend.
    Raises a ``ValueError`` unless T divides the world size (one process
    counts as a world of 1). At T = 1 there is no grid: the data index and
    count are the process's."""
    global _GRID
    T = int(model_parallel)
    R = process_count()
    if T < 1 or R % T:
        raise ValueError(f"--mesh_model_parallel {T} does not divide the {R} ranks of the "
                         f"process group")
    _GRID = None
    if T == 1:
        return
    gloo = dist.get_backend() == "gloo"

    def groups(rank_lists):
        mine = None
        for ranks in rank_lists:
            g = dist.new_group(ranks)
            g_cpu = g if gloo else dist.new_group(ranks, backend="gloo")
            if process_index() in ranks:
                mine = (g, g_cpu, ranks)
        return mine
    D = R // T
    data = groups([[d * T + m for d in range(D)] for m in range(T)])
    model = groups([[d * T + m for m in range(T)] for d in range(D)])
    _GRID = {"T": T, "data": data, "model": model}


def model_count() -> int:
    """T, the ranks of a model group (1 without a grid)."""
    return _GRID["T"] if _GRID else 1


def model_index() -> int:
    """This rank's index in its model group, ``rank % T`` (0 without a grid)."""
    return process_index() % _GRID["T"] if _GRID else 0


def data_count() -> int:
    """The data indices, ``R // T``: the ranks that hold different rows."""
    return process_count() // model_count()


def data_index() -> int:
    """This rank's rows of the global batch, ``rank // T``."""
    return process_index() // model_count()


def data_group():
    """The group of the ranks of this rank's model index (None, the default
    group, without a grid)."""
    return _GRID["data"][0] if _GRID else None


def data_cpu_group():
    """``data_group``'s gloo twin, for host collectives."""
    return _GRID["data"][1] if _GRID else cpu_group()


def data_src() -> int:
    """The global rank of data index 0 in this rank's data group."""
    return _GRID["data"][2][0] if _GRID else 0


def model_group():
    """The group of this rank's model peers (None without a grid)."""
    return _GRID["model"][0] if _GRID else None


def model_cpu_group():
    """``model_group``'s gloo twin."""
    return _GRID["model"][1] if _GRID else None


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
    local shape, ``dim`` its batch axis. Over D data indices every rank
    draws the global shape (D times the rows along ``dim``) from
    ``generator`` and keeps rows ``[d*b, (d+1)*b)`` of its data index d, so
    the generators of all ranks stay in step, model peers draw alike, and
    the step draws what the one-process step draws on the concatenated
    batch. One process draws ``shape`` itself, as before.
    ``draw(shape)`` replaces ``torch.rand`` (e.g. a ``torch.randint``);
    ``device`` defaults to the generator's."""
    if draw is None:
        def draw(s):
            return torch.rand(s, generator=generator, device=device or generator.device,
                              dtype=dtype)
    shape = tuple(int(s) for s in shape)
    D = data_count()
    if D == 1:
        return draw(shape)
    b = shape[dim]
    full = draw(shape[:dim] + (b * D,) + shape[dim + 1:])
    return full.narrow(dim, data_index() * b, b)


def randint_local(high: int, shape: Sequence[int], generator: torch.Generator,
                  dim: int = 0) -> torch.Tensor:
    """``rand_local`` of ``torch.randint(0, high, ...)``."""
    return rand_local(shape, generator, dim, draw=lambda s: torch.randint(
        0, high, s, generator=generator, device=generator.device))
