"""Device resolution and the build, load and launch plumbing of the CUDA kernels.

Each kernel source ``act_tpu_torch/csrc/<stem>.cu`` exports plain C launch
functions, one per kernel (``chamfer.cu`` holds three). On first use the
sources are compiled by ``nvcc`` for ``sm_90a``,
one process per source and all started together, into shared libraries under
``build/act_tpu_torch/`` at the repository root (named by the source's hash, so
an edited source is rebuilt), and loaded with ``ctypes``.

There is no kernel switch: a wrapper picks its path from the tensor's device
alone. A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises. ``LAUNCHES`` counts the kernel launches of each wrapper.

The kernels of the serving paths (FPS, k-smallest, the gather) launch through
ops registered with ``torch.library`` (namespace ``act_tpu_torch``): a CUDA
implementation that launches the kernel, the plain version as the CPU
implementation, and a fake implementation that gives the output shapes, so
that ``torch.export`` of a forward on the card keeps each kernel as an
``act_tpu_torch::*`` node (``engine/export.py``). Importing
``act_tpu_torch.ops`` registers them; that is all an exported artifact needs.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

import torch
from torch.utils.flop_counter import register_flop_formula

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "act_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel -> (source csrc/<stem>.cu, C launch function, its argument types)
KERNELS = {
    "fps": ("fps", "act_fps", [_P] * 4 + [_I] * 6 + [_P]),
    "k_smallest": ("topk", "act_ksmallest", [_P, _P, _P, _I, _I, _I, _P]),
    "gather": ("gather", "act_gather", [_P, _P, _P] + [_I] * 6 + [_P]),
    "gumbel_argmax": ("gumbel", "act_gumbel_argmax", [_P, _P, _P] + [_I] * 6 + [_P]),
    "chamfer_nn": ("chamfer", "act_chamfer_nn", [_P] * 7 + [_I] * 8 + [_P]),
    "chamfer_nn_min": ("chamfer", "act_chamfer_nn_min", [_P] * 4 + [_I] * 8 + [_P]),
    "chamfer_bwd": ("chamfer", "act_chamfer_bwd", [_P] * 8 + [_I] * 3 + [_P]),
    "row_gather_bwd": ("rows", "act_row_gather_bwd", [_P] * 5 + [_I] * 6 + [_P]),
}

# the kernels whose wrappers are not ``act_tpu_torch::*`` ops (``custom_op``)
PLAIN_WRAPPERS = ("gumbel_argmax", "chamfer_nn", "chamfer_nn_min", "chamfer_bwd",
                  "row_gather_bwd")
# launches of each kernel wrapper: plain counters, read and reset by callers
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
# ptxas resource report of each source's build (registers, shared memory, spills)
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, Callable] = {}  # kernel -> its bound C launch function
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.

    The port's entry points default to the card. Only an explicit ``"cpu"``
    runs on the CPU, where every kernel takes its plain version."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions")
        # f32 products (the kNN distances, the f32 head) in full f32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _source(name: str) -> Path:
    return CSRC / f"{KERNELS[name][0]}.cu"


def _target(name: str) -> Path:
    digest = hashlib.sha256(_source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{KERNELS[name][0]}-{digest}.so"


def build_kernels(names=tuple(KERNELS)) -> Dict[str, ctypes.CDLL]:
    """Compile (where not built yet) and load the named kernel libraries.

    All missing sources compile at once, one ``nvcc`` process each (kernels
    that share a source share its build). Raises with nvcc's output if a
    build fails."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        procs = {}
        for n in todo:
            stem, out = KERNELS[n][0], _target(n)
            if stem in procs or out.is_file():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".so.tmp{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(n))]
            procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        for n in todo:
            lib = ctypes.CDLL(str(_target(n)))
            _, fn_name, argtypes = KERNELS[n]
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            lib.act_cuda_error_string.argtypes = [ctypes.c_int]
            lib.act_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[n], _FNS[n] = lib, fn
        return {n: _LIBS[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built at first use), for its
    other exported functions."""
    if name not in _LIBS:
        build_kernels((name,))
    return _LIBS[name]


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s launch function on the current CUDA stream,
    raise if the launch failed, and count it in ``LAUNCHES``. A kernel of
    ``PLAIN_WRAPPERS`` launches inside a profiler range
    ``act_tpu_torch::<name>``, which names it in a profile as its op names
    a registered kernel (a range costs host time only while a profiler runs).

    ``args`` are tensors (passed by data pointer) and ints, in the order of
    the C signature without the trailing stream."""
    fn = _FNS.get(name)
    if fn is None:
        build_kernels((name,))
        fn = _FNS[name]
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
              for a in args]
    with (torch.profiler.record_function(f"act_tpu_torch::{name}") if name in PLAIN_WRAPPERS
          else contextlib.nullcontext()):
        err = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = _LIBS[name].act_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} ({msg})")
    LAUNCHES[name] += 1


def custom_op(name: str) -> Callable:
    """Register the decorated function, the CUDA launch of kernel ``name``,
    as the op ``act_tpu_torch::<name>``."""
    return torch.library.custom_op(f"act_tpu_torch::{name}", mutates_args=(),
                                   device_types="cuda")


def register_op(op, cpu_impl: Callable, fake_impl: Callable, flops: Callable) -> None:
    """Give a registered kernel op its CPU implementation (the plain
    version), its fake implementation (output shapes and dtypes, for
    tracing), a backward that passes no gradient (a kernel's output is
    not differentiated on the card: indices, and gathered coordinates of
    clouds that take no gradient), and its ``FlopCounterMode`` formula
    ``flops`` (``ops/work.py``)."""
    register_flop_formula(op._opoverload._overloadpacket)(flops)
    op.register_kernel("cpu")(cpu_impl)
    op.register_fake(fake_impl)
    op.register_autograd(lambda ctx, *grads: (None,) * ctx.n_inputs,
                         setup_context=lambda ctx, inputs, output: setattr(
                             ctx, "n_inputs", len(inputs)))


def check_cuda_input(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    """A kernel input must be a contiguous CUDA tensor of ``dtype``."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel takes a contiguous tensor")
