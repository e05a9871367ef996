"""Point-cloud file readers: ``.npy``, ``.h5`` and ``.txt``.

The port's own copy of ``act_tpu/datasets/io.py:1-75`` (reference
datasets/io.py:6-42). A ``.npy`` header is parsed once for each distinct
header and then kept: a dataset tree holds thousands of files whose headers
are byte-identical, and ``np.load`` would parse the dict literal again for
every file. ``h5py`` is imported only to read an ``.h5`` file.
"""
from __future__ import annotations

import ast
import os

import numpy as np

_NPY_HEADER_CACHE: dict = {}  # header bytes -> (dtype, shape), or None for np.load


def _read_npy_fast(file_path: str) -> np.ndarray:
    """``np.load`` of a plain little-endian C-order ``.npy`` file with the
    header parse memoised; anything unusual (pickled objects, Fortran order,
    a version 3 header) goes through ``np.load``."""
    with open(file_path, "rb") as f:
        pre = f.read(8)
        if len(pre) < 8 or pre[:6] != b"\x93NUMPY":
            raise ValueError(f"{file_path}: not a valid .npy file (bad or truncated header)")
        major = pre[6]
        if major == 1:
            hlen = int.from_bytes(f.read(2), "little")
        elif major == 2:
            hlen = int.from_bytes(f.read(4), "little")
        else:
            return np.load(file_path)
        header = f.read(hlen)
        if header not in _NPY_HEADER_CACHE:
            d = ast.literal_eval(header.decode("latin1"))
            dtype = np.dtype(d["descr"])
            _NPY_HEADER_CACHE[header] = (None if d.get("fortran_order") or dtype.hasobject
                                         else (dtype, tuple(d["shape"])))
        meta = _NPY_HEADER_CACHE[header]
        if meta is None:
            return np.load(file_path)
        dtype, shape = meta
        arr = np.fromfile(f, dtype=dtype, count=int(np.prod(shape)) if shape else 1)
        return arr.reshape(shape) if shape else arr[0]


class IO:
    @classmethod
    def get(cls, file_path: str) -> np.ndarray:
        ext = os.path.splitext(file_path)[1]
        if ext == ".npy":
            return _read_npy_fast(file_path)
        if ext == ".h5":
            import h5py  # only for an .h5 file
            with h5py.File(file_path, "r") as f:
                return f["data"][()]
        if ext == ".txt":
            return np.loadtxt(file_path, delimiter=",")
        raise ValueError(f"Unsupported file extension: {ext}")
