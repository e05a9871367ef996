"""The arithmetic of each kernel's function, counted from its shapes.

One formula a kernel, counting the operations of the function it computes,
not of one implementation of it: the count is the same whether the CUDA
kernel on the card or its plain version on the CPU computes the function.
``act_tpu_torch.get_flops`` adds these counts to ``FlopCounterMode``'s for
a model's FLOPs, and ``chip_smoke.py`` reads them for the kernels' compute
bounds, so both count the same work. An operation is one floating-point or
integer step (an add, a product, a compare, a log), as
``FlopCounterMode`` counts a product's multiply and add as two.

- FPS: ``FPS_OPS`` a point a step (3 subtractions, 3 products and 2 sums
  for the squared distance to the last pick, 1 minimum, 1 compare for the
  argmax), over the S - 1 steps after the start;
- k-smallest and the gather select and copy: no arithmetic;
- Gumbel: ``GUMBEL_OPS`` a lane, the noise and the add for every lane and
  the argmax's compare, as the plain version computes them (the kernel
  takes the exact noise for only ~1 lane a row, see ``csrc/gumbel.cu``);
- Chamfer, both directed nearest neighbours (with or without indices):
  ``CHAMFER_OPS`` a pair; its backward ``CHAMFER_BWD_OPS`` a point;
- the row gathers' backward: one add an element of the gradient.

FPS, k-smallest and the gather launch through ``torch.library`` ops, whose
formulas ``_backend.register_op`` registers with ``FlopCounterMode``: on the
card it counts them at the op. Their wrappers' CPU branches call the plain version without
the op, so they record the same formula with :func:`record`, as the wrappers
of the Gumbel, Chamfer and row-gather kernels (plain wrappers, which
``FlopCounterMode`` does not see) do on both paths. :class:`Work` collects
what is recorded while it is open.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

FPS_OPS = 10
GUMBEL_OPS = 24  # counted from the expression in the note of csrc/gumbel.cu
CHAMFER_OPS = 10  # 8 for the squared distance, computed once, and 1 compare a direction
CHAMFER_BWD_OPS = 15  # 3 subtractions, 6 products and 6 sums a point


def fps(B: int, N: int, S: int) -> int:
    """(B, N, 3) clouds -> S picks each."""
    return FPS_OPS * B * N * max(S - 1, 0)


def k_smallest(rows: int, n: int, k: int) -> int:
    return 0


def gather(B: int, S: int, C: int) -> int:
    return 0


def gumbel_argmax(rows: int, v: int) -> int:
    return GUMBEL_OPS * rows * v


def chamfer_nn(B: int, N: int, M: int) -> int:
    """(B, N, 3) against (B, M, 3); ``chamfer_nn_min`` does the same work."""
    return CHAMFER_OPS * B * N * M


def chamfer_bwd(B: int, N: int, M: int) -> int:
    return CHAMFER_BWD_OPS * B * (N + M)


def row_gather_bwd(B: int, M: int, C: int) -> int:
    """(B, M, C) gradient rows summed into their destinations."""
    return B * M * C


FORMULAS: Dict[str, Callable[..., int]] = {
    "fps": fps, "k_smallest": k_smallest, "gather": gather, "gumbel_argmax": gumbel_argmax,
    "chamfer_nn": chamfer_nn, "chamfer_nn_min": chamfer_nn, "chamfer_bwd": chamfer_bwd,
    "row_gather_bwd": row_gather_bwd}


class Work:
    """The kernel work recorded while open (``with Work() as w``): operations
    and calls by kernel name."""

    def __init__(self):
        self.flops: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}

    def __enter__(self) -> "Work":
        _OPEN.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _OPEN.remove(self)

    def total(self) -> int:
        return sum(self.flops.values())


_OPEN: List[Work] = []


def record(name: str, *shape: int) -> None:
    """Add kernel ``name``'s formula at ``shape`` to every open :class:`Work`."""
    if _OPEN:
        n = FORMULAS[name](*shape)
        for w in _OPEN:
            w.flops[name] = w.flops.get(name, 0) + n
            w.calls[name] = w.calls.get(name, 0) + 1


# the registered ops' formulas for FlopCounterMode (``_backend.register_op``),
# which passes the tensors' shapes in their place
def fps_op(points_shape, start_shape, n_samples, *args, **kwargs) -> int:
    return fps(points_shape[0], points_shape[1], n_samples)


def k_smallest_op(d_shape, k, *args, **kwargs) -> int:
    return k_smallest(math.prod(d_shape[:-1]), d_shape[-1], k)


def gather_op(points_shape, idx_shape, *args, **kwargs) -> int:
    return gather(points_shape[0], math.prod(idx_shape[1:]), points_shape[-1])
