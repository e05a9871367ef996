"""Sweeps of the FPS, Chamfer, Gumbel and gather kernels' launch geometries
and times of the k-smallest and row-gather backward kernels on one CUDA
card, beside an earlier version of the redesigned kernels.

  python -m act_tpu_torch.kernel_sweep [--parent DIR] [--out FILE]

For each FPS shape of the port's paths it runs ``csrc/fps.cu`` at every
cluster size (1, 2, 4, 8) and the points a thread (1-16) that keep a block
small, checks the picks against the plain version (equal up to adjacent tie
swaps) and prints the profiler device time of each geometry beside the one
``launch_geometry`` picks, and the SM clock while the picked one runs. It times ``csrc/topk.cu`` at the path's shapes against its plain
version (indices equal, values bit-equal) and ``torch.topk``. It runs
``chamfer_nn`` and ``chamfer_nn_min`` (``csrc/chamfer.cu``) at the
validation, whole-cloud, both recon and a ragged shape, at each tiling it
sweeps and the one ``ops/chamfer.py`` ``launch_geometry`` picks, checks every
run against the plain versions (distances bit-equal, indices equal) and
prints the device times. It runs ``chamfer_bwd`` at both recon shapes (the
group body, checked bit-equal to the plain version run on the CPU) and at a
validation-sized pair (the atomic body, within ``BWD_RTOL``). It runs
``csrc/gumbel.cu`` at the Stage-II shape
(bf16 and f32) and at smaller and ragged ones, at each bucket count and grid
it sweeps and the one ``ops/sampling.py`` ``launch_geometry`` picks, checks
every run id for id against
``gumbel_argmax_ref`` (outputs filled with -1 before each checked run), and
prints the device times and the screen's survivors a row (from its plain
model ``sampling.screen_ref``). It runs ``csrc/gather.cu`` at every gather
shape of the paths with each body at 128 and 256 threads and the
(body, threads) that ``ops/gather.py`` ``launch_geometry`` picks, each run
checked bit-equal to ``gather_points``. It runs ``row_gather_bwd``
(``csrc/rows.cu``) at the Stage-I DGCNN's rounds and one part-seg 3-NN
gather on uniform random indices, a launch that lists the sources and one
that reads the list, each bit-equal to ``gather_rows_bwd_ref``.
Checked runs write into outputs first filled with NaN or -1. A device time
that the profiler did not record in full is reported as not measured
(``act_tpu_torch/profiling.py``).
With ``--parent DIR`` (a checkout that holds an earlier ``act_tpu_torch/csrc``
and ``act_tpu_torch/ops/_backend.py``), that version's ``chamfer.cu`` and
``gather.cu`` and ``rows.cu``, where they exist there and differ from the
current ones, are built too and their ``chamfer_bwd``, gather and
row-gather backward are timed at the same shapes in the same process, in
turns with the current ones (parent, current, current, parent; the row
gather's against a launch that lists the sources).
Writes every row as JSON to ``--out`` (default
``chiprun_out/kernel_sweep.json``).
"""
from __future__ import annotations

import argparse
import ast
import ctypes
import json
import subprocess
import time
from pathlib import Path

import torch

from act_tpu_torch import ops
from act_tpu_torch.ops import _backend
from act_tpu_torch.ops import chamfer as chamfer_mod
from act_tpu_torch.ops import gather as gather_mod
from act_tpu_torch.ops import sampling
from act_tpu_torch.ops.fps import MAX_PPT, _max_clusters, _sms, launch_geometry, tie_swaps
from act_tpu_torch.ops.reference import gumbel_chunk
from act_tpu_torch.profiling import card_line, device_ms

# the serving resample at B=32 and B=1, Stage II's centers (Stage I's at B=64
# take the same geometry), the SVM probe's resample, the largest clouds
FPS_SHAPES = [(32, 8192, 1024), (1, 8192, 1024), (128, 1024, 64), (256, 8192, 1024),
              (8, 16384, 512)]
TOPK_SHAPES = [(8192, 1024, 32), (8192, 64, 4), (2048, 1024, 32), (4096, 1024, 32),
               (4096, 64, 4)]
# Chamfer shape (B, N, M) -> the tilings (tq, tt, r, threads, pack) swept
# beside launch_geometry's pick: one validation cloud, the whole-cloud op,
# the recon loss's two calls, a ragged pair
CHAMFER_SHAPES = {
    (1, 2048, 1024): [(64, 64, 8, 64, 1), (64, 64, 2, 64, 1), (128, 64, 8, 64, 1),
                      (32, 64, 8, 64, 1), (64, 128, 8, 128, 1), (64, 64, 4, 64, 1)],
    (32, 2048, 2048): [(256, 512, 8, 256, 1), (256, 1024, 8, 256, 1), (128, 512, 8, 256, 1),
                       (64, 512, 8, 256, 1), (256, 512, 16, 256, 1), (256, 256, 8, 256, 1)],
    (4096, 8, 32): [(8, 32, 4, 64, 8), (8, 32, 8, 64, 8), (8, 32, 2, 64, 8), (8, 32, 4, 64, 4),
                    (8, 32, 4, 128, 16), (8, 32, 4, 32, 8)],
    (4096, 32, 32): [(32, 32, 8, 128, 8), (32, 32, 4, 128, 8), (32, 32, 4, 256, 16),
                     (32, 32, 4, 64, 4), (32, 32, 4, 256, 8), (32, 32, 8, 256, 16)],
    (3, 777, 1001): [(128, 64, 8, 64, 1), (64, 64, 8, 64, 1), (128, 64, 4, 64, 1),
                     (256, 128, 8, 128, 1), (128, 128, 8, 128, 1), (32, 64, 8, 64, 1)],
}

# Gumbel-argmax (rows, V, dtype): the Stage-II shape in both dtypes, one row
# (screened), a V below a tile and a ragged V (both taken exactly)
GUMBEL_SHAPES = [(8192, 8192, torch.bfloat16), (8192, 8192, torch.float32),
                 (1, 8192, torch.bfloat16), (300, 1000, torch.bfloat16),
                 (37, 1001, torch.float32)]
GUMBEL_BITS = (6, 8, 10)


# chamfer_bwd (B, N, M): both recon calls of a Stage-I step (the group body)
# and one validation-sized pair (the atomic body, within BWD_RTOL)
BWD_SHAPES = [(4096, 8, 32), (4096, 32, 32), (1, 2048, 1024)]
BWD_RTOL = 1e-5  # the atomic body: f32 sums in a changing order
# gather (B, N, S): Stage II's centers and neighbourhoods, Stage I's, the
# B=32 request's resample, centers and neighbourhoods, and the B=1 request's
GATHER_SHAPES = [(128, 1024, 64), (128, 1024, 2048), (64, 1024, 64), (64, 1024, 2048),
                 (32, 8192, 1024), (32, 1024, 64), (32, 1024, 2048), (1, 8192, 1024),
                 (1, 1024, 64), (1, 1024, 2048)]
# gather (tile, threads) swept beside the pick: each body at 128 and 256
GATHER_GEOMETRIES = ((False, 128), (False, 256), (True, 128), (True, 256))
# the sources whose earlier version --parent times
PARENT_STEMS = ("chamfer", "gather", "rows")
# row_gather_bwd (B, M, S, C, dtype): the Stage-I DGCNN's rounds (bf16) and one of
# part seg's three 3-NN gathers (f32)
ROW_SHAPES = [(64, 256, 64, 512, torch.bfloat16), (64, 256, 64, 256, torch.bfloat16),
              (64, 256, 64, 128, torch.bfloat16), (16, 2048, 128, 1152, torch.float32)]


def parent_kernels(parent: Path) -> dict:
    """The parent commit's own kernel table, ``KERNELS`` of its
    ``act_tpu_torch/ops/_backend.py`` (name -> (source stem, C launch
    function, argument types)), read without importing that module."""
    tree = ast.parse((parent / "act_tpu_torch" / "ops" / "_backend.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "KERNELS" for t in n.targets))
    return eval(compile(ast.Expression(node.value), "parent KERNELS", "eval"),
                {"_P": ctypes.c_void_p, "_I": ctypes.c_int})


def build_parent(parent: Path) -> dict:
    """The earlier ``PARENT_STEMS`` sources that differ from the current
    ones, built as in ``_backend``, by C launch function, each bound with
    its signature at the parent commit (from :func:`parent_kernels`)."""
    table = parent_kernels(parent)
    out_dir = _backend.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in PARENT_STEMS:
        src = parent / "act_tpu_torch" / "csrc" / f"{stem}.cu"
        if not src.exists() or src.read_bytes() == (_backend.CSRC / f"{stem}.cu").read_bytes():
            continue
        so = out_dir / f"{stem}.so"
        cmd = [_backend._nvcc(), *_backend.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for stem, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent {stem}.cu failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for src_stem, name, argtypes in table.values():
            if src_stem == stem:
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                fns[name] = fn
    return fns


def fmt(ms) -> str:
    """A device time in ms, or why there is none."""
    return "not measured" if ms is None else f"{ms:.5f}"


def call(fn, *args) -> None:
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else int(a) for a in args],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")


def fps_geometries(N: int):
    """Cluster sizes 1, 2, 4, 8 at the points a thread that keep a block within 256
    threads (or the fewest threads that cover the slice)."""
    for c in (1, 2, 4, 8):
        slice_ = -(-N // c)
        ppt = 1
        while ppt <= MAX_PPT:
            threads = -(-slice_ // ppt)
            threads = max(32, -(-threads // 32) * 32)
            if (threads <= max(256, -(-slice_ // 16)) and (threads >= 64 or ppt == 1)
                    and ppt <= max(1, slice_ // 64)):
                yield c, threads, ppt
            ppt *= 2


def sm_clock_mhz(fn, seconds: float = 1.0) -> str:
    """The SM clock (nvidia-smi) sampled while ``fn`` runs back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds / 2:
        fn()
        n += 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True)
    torch.cuda.synchronize()
    return out.stdout.strip()


def chamfer_runs(x: torch.Tensor, y: torch.Tensor, geo) -> dict:
    """Closures that launch ``chamfer_nn`` and ``chamfer_nn_min`` once at
    tiling ``geo`` and return their outputs."""
    (B, N, _), M = x.shape, y.shape[1]
    # NaN and -1 until a launch writes them: a launch that writes nothing fails the check
    d1, d2 = x.new_full((B, N), float("nan")), x.new_full((B, M), float("nan"))
    i1, i2 = (torch.full((B, n), -1, dtype=torch.int32, device=x.device) for n in (N, M))
    out = x.new_full((B * (N + M),), float("nan"))
    m1, m2 = out[:B * N].view(B, N), out[B * N:].view(B, M)
    keys = (torch.empty(B * (N + M), dtype=torch.int64, device=x.device)
            if N > geo[0] or M > geo[1] else 0)

    def nn():
        _backend.launch("chamfer_nn", x, y, d1, i1, d2, i2, keys, B, N, M, *geo)
        return d1, d2, i1, i2

    def nn_min():
        _backend.launch("chamfer_nn_min", x, y, m1, m2, B, N, M, *geo)
        return m1, m2
    return {"chamfer_nn": nn, "chamfer_nn_min": nn_min}


def gumbel_geometries(rows: int, v: int, sms: int):
    """(k, blocks): each bucket count swept, on the persistent grid (the
    blocks that stay resident, or as many as the rows need) and on a grid of
    a block for every 8 rows."""
    for k in GUMBEL_BITS:
        for blocks in {sampling.launch_geometry(rows, v, sms)[1], -(-rows // sampling.WARPS)}:
            yield k, blocks


def gumbel_launch(logits: torch.Tensor, seed: torch.Tensor, out: torch.Tensor, geo) -> None:
    """``csrc/gumbel.cu`` at geometry (k, blocks)."""
    v = logits.shape[-1]
    rows = logits.numel() // v
    _backend.launch("gumbel_argmax", logits, seed, out, rows, v, gumbel_chunk(rows, v),
                    int(logits.dtype == torch.bfloat16), *geo)


def sweep_gumbel(dev, sms: int, rows: list, bad: list) -> None:
    """The Gumbel part of the sweep: rows to ``rows``, failures to ``bad``."""
    for rows_, v, dtype in GUMBEL_SHAPES:
        shape = f"({rows_}, {v}) {str(dtype).split('.')[-1]}"
        g = torch.Generator(device=dev).manual_seed(rows_ + v)
        logits = torch.randn(rows_, v, generator=g, device=dev).to(dtype)
        seed = torch.tensor([123456789, -5], dtype=torch.int32, device=dev)
        want = ops.gumbel_argmax_ref(logits, seed)
        bits = sampling.hash_bits(rows_, v, seed, dev)
        live = {k: sampling.screen_ref(logits, bits, k) for k in GUMBEL_BITS}
        del bits
        out = torch.empty(rows_, dtype=torch.int32, device=dev)
        picked = sampling.launch_geometry(rows_, v, sms)
        iters = 20 if rows_ * v > 2 ** 22 else 100
        times = {}
        for geo in sorted(set(gumbel_geometries(rows_, v, sms)) | {picked}):
            out.fill_(-1)
            gumbel_launch(logits, seed, out, geo)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                n = int((out != want).sum())
                print(f"MISMATCH gumbel_argmax {shape} at {geo}: {n} ids differ")
                bad.append(f"gumbel_argmax {shape} {geo}")
                continue
            ms = device_ms(lambda geo=geo: gumbel_launch(logits, seed, out, geo), iters)
            rows.append(dict(kernel="gumbel_argmax", shape=[rows_, v, str(dtype)],
                             geometry=list(geo), picked=geo == picked, ms=ms))
            if ms is None:
                print(f"    gumbel_argmax {geo}: device records incomplete, not measured")
            else:
                times[geo] = ms
        for k, (ids, n) in live.items():
            if not torch.equal(ids, want):
                bad.append(f"gumbel screen model {shape} k={k}")
            rows.append(dict(kernel="gumbel_survivors", shape=[rows_, v, str(dtype)], k=k,
                             mean=float(n.float().mean()), max=int(n.max())))
        if picked not in times:
            continue
        best = min(times, key=times.get)
        line = (f"[gumbel_argmax] {shape}: picked (k, blocks) = {picked} "
                f"{times[picked]:.5f} ms; best {best} {times[best]:.5f} ms; survivors a row "
                + ", ".join(f"k={k} {float(n.float().mean()):.2f} (max {int(n.max())})"
                            for k, (_, n) in live.items()))
        if rows_ * v > 2 ** 22:
            clock = sm_clock_mhz(lambda: ops.gumbel_argmax(logits, seed))
            rows.append(dict(kernel="gumbel_clock", shape=[rows_, v, str(dtype)],
                             sm_clock_power=clock))
            line += f"; SM clock, power while it runs: {clock}"
        print(line, flush=True)
        for geo, t in sorted(times.items()):
            print(f"    {geo}: {fmt(t)} ms", flush=True)


def parent_vs_current(run_old, run_new, iters: int):
    """Device times in turns: parent, current, current, parent."""
    t_old = [device_ms(run_old, iters)]
    t_new = [device_ms(run_new, iters) for _ in range(2)]
    t_old.append(device_ms(run_old, iters))
    return t_old, t_new


def turns(t_old, t_new) -> str:
    return (f"parent {fmt(t_old[0])}/{fmt(t_old[1])} ms, current {fmt(t_new[0])}/"
            f"{fmt(t_new[1])} ms (parent, current, current, parent)")


def sweep_chamfer_bwd(dev, old: dict, rows: list, bad: list) -> None:
    """``chamfer_bwd`` at ``BWD_SHAPES`` from the plain forward's indices:
    the group body bit-equal to the plain version run on the CPU, the atomic
    body within ``BWD_RTOL`` of the largest gradient; the parent's in turns."""
    gen = torch.Generator().manual_seed(7)
    for B, N, M in BWD_SHAPES:
        args = [torch.randn(B, N, 3, generator=gen), torch.randn(B, M, 3, generator=gen)]
        args += list(ops.chamfer_ref(*args)[2:])
        args += [torch.randn(B, N, generator=gen), torch.randn(B, M, generator=gen)]
        want = ops.chamfer_bwd_ref(*args)
        a = [t.to(dev) for t in args]
        dx, dy = torch.empty_like(a[0]), torch.empty_like(a[1])
        group = max(N, M) <= 32

        def check(tag, launch):
            dx.fill_(float("nan"))
            dy.fill_(float("nan"))
            launch()
            torch.cuda.synchronize()
            for g, w in zip((dx.cpu(), dy.cpu()), want):
                ok = (torch.equal(g, w) if group and tag == "current" else
                      bool(((g - w).abs() <= BWD_RTOL * w.abs().max()).all()))
                if not ok:
                    print(f"MISMATCH chamfer_bwd {tag} {(B, N, M)}: differs from the plain version")
                    bad.append(f"chamfer_bwd {tag} {(B, N, M)}")

        def run_new():
            _backend.launch("chamfer_bwd", *a, dx, dy, B, N, M)
        check("current", run_new)
        line = (f"[chamfer_bwd] ({B}, {N})x({B}, {M}) {'group' if group else 'atomic'} body: "
                f"{'bit-equal' if group else f'within {BWD_RTOL}'}")
        row = dict(kernel="chamfer_bwd", shape=[B, N, M], body="group" if group else "atomic")
        if "act_chamfer_bwd" in old:
            def run_old():
                call(old["act_chamfer_bwd"], *a, dx, dy, B, N, M)
            check("parent", run_old)
            t_old, t_new = parent_vs_current(run_old, run_new, 100)
            row.update(parent_ms=t_old, ms=t_new)
            line += "; " + turns(t_old, t_new)
        else:
            row.update(ms=device_ms(run_new, 100))
            line += f"; {fmt(row['ms'])} ms"
        rows.append(row)
        print(line, flush=True)


def sweep_gather(dev, old: dict, rows: list, bad: list) -> None:
    """The gather at ``GATHER_SHAPES`` (C = 3) at each (body, threads) of
    ``GATHER_GEOMETRIES`` and the pick, each run bit-equal to
    ``gather_points``; the parent's in turns."""
    gen = torch.Generator().manual_seed(8)
    for B, N, S in GATHER_SHAPES:
        pts = torch.randn(B, N, 3, generator=gen).to(dev)
        idx = torch.randint(0, N, (B, S), generator=gen, dtype=torch.int32).to(dev)
        want = ops.gather_points(pts, idx)
        out = torch.empty(B, S, 3, device=dev)
        picked = gather_mod.launch_geometry(B, S, True)  # fresh tensors: aligned
        times = {}
        for geo in sorted(set(GATHER_GEOMETRIES) | {picked}):
            def run(geo=geo):
                _backend.launch("gather", pts, idx, out, B, N, S, 3, *geo)
            out.fill_(float("nan"))
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"MISMATCH gather {(B, N, S)} at {geo}: not bit-equal")
                bad.append(f"gather {(B, N, S)} {geo}")
                continue
            times[geo] = device_ms(run, 200)
            rows.append(dict(kernel="gather", shape=[B, N, S], geometry=list(geo),
                             picked=geo == picked, ms=times[geo]))
        line = (f"[gather] ({B}, {N}, 3) by ({B}, {S}): picked (tile, threads) = {picked} "
                f"{fmt(times.get(picked))} ms; " + ", ".join(
                    f"{g}: {fmt(ms)}" for g, ms in sorted(times.items())))
        if "act_gather" in old:
            # the arguments of the parent's signature (without the geometry
            # where it takes none)
            old_args = (pts, idx, out, B, N, S, 3, *picked)[:len(old["act_gather"].argtypes) - 1]

            def run_old():
                call(old["act_gather"], *old_args)
            out.fill_(float("nan"))
            run_old()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                bad.append(f"parent gather {(B, N, S)}")
            t_old, t_new = parent_vs_current(run_old, lambda: ops.gather_coords(pts, idx), 200)
            rows.append(dict(kernel="gather_parent", shape=[B, N, S], ms=t_old, new_ms=t_new))
            line += "; " + turns(t_old, t_new)
        print(line, flush=True)


def sweep_row_gather(dev, old: dict, rows: list, bad: list) -> None:
    """``row_gather_bwd`` at ``ROW_SHAPES``: a launch at a fresh index (it
    lists the sources) and one at an index listed before (it reads the
    list), each bit-equal to the plain version; the parent's in turns with
    the listing one."""
    gen = torch.Generator().manual_seed(9)
    for B, M, S, C, dt in ROW_SHAPES:
        grad = torch.randn(B, M, C, generator=gen).to(dt).to(dev)
        idx = torch.randint(0, S, (B, M), generator=gen, dtype=torch.int32).to(dev)
        want = ops.gather_rows_bwd_ref(grad, idx, S)
        listed = ops.row_index(idx, S)
        runs = {"listing": lambda: ops.gather_rows_bwd(grad, ops.row_index(idx, S)),
                "reading": lambda: ops.gather_rows_bwd(grad, listed)}
        for tag, run in runs.items():
            if not torch.equal(run(), want):
                print(f"MISMATCH row_gather_bwd {tag} {(B, M, S, C)}: not bit-equal")
                bad.append(f"row_gather_bwd {tag} {(B, M, S, C)}")
        times = {tag: device_ms(run, 100) for tag, run in runs.items()}
        row = dict(kernel="row_gather_bwd", shape=[B, M, S, C], dtype=str(dt), **times)
        line = (f"[row_gather_bwd] ({B}, {M}, {C}) {dt} into {S} rows: listing "
                f"{fmt(times['listing'])} ms, reading the list {fmt(times['reading'])} ms")
        if "act_row_gather_bwd" in old:
            out = torch.empty(B, S, C, dtype=dt, device=dev)
            order = torch.empty(B * M, dtype=torch.int32, device=dev)
            starts = torch.empty(B * (S + 1), dtype=torch.int32, device=dev)
            code = 0 if dt == torch.float32 else 1

            def run_old():
                call(old["act_row_gather_bwd"], grad, idx, out, order, starts, B, M, S, C, code)
            out.fill_(float("nan"))
            run_old()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                bad.append(f"parent row_gather_bwd {(B, M, S, C)}")
            t_old, t_new = parent_vs_current(run_old, runs["listing"], 100)
            row.update(parent_ms=t_old, listing_ms=t_new)
            line += "; " + turns(t_old, t_new)
        rows.append(row)
        print(line, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/kernel_sweep.json"))
    args = ap.parse_args()
    dev = _backend.resolve_device("cuda")
    _backend.build_kernels(("fps", "k_smallest", "chamfer_nn", "gumbel_argmax", "gather",
                            "row_gather_bwd"))
    for stem in ("fps", "topk", "chamfer", "gumbel", "gather", "rows"):
        for line in _backend.BUILD_LOG.get(stem, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {stem}: {line.strip()}")
    old = build_parent(args.parent) if args.parent else {}
    card = card_line()
    print(f"card: {card}", flush=True)
    sms = _sms(dev.index or 0)
    rows, bad = [], []
    gen = torch.Generator().manual_seed(0)
    for B, N, S in FPS_SHAPES:
        pts = torch.randn(B, N, 3, generator=gen).to(dev)
        start = torch.zeros(B, dtype=torch.int32, device=dev)
        want = ops.furthest_point_sample_ref(pts, S)
        picked = launch_geometry(B, N, sms, _max_clusters)
        out = torch.empty(B, S, dtype=torch.int32, device=dev)
        iters = 5 if N * S > 2 ** 22 else 20
        times = {}
        for geo in sorted(set(fps_geometries(N)) | {picked}):
            c, threads, ppt = geo
            if _max_clusters(N, c, threads, ppt) <= 0:
                continue

            def run(geo=geo):
                _backend.launch("fps", pts, start, out, B, N, S, *geo)
            run()
            torch.cuda.synchronize()
            n_sw = tie_swaps(out, want)
            if n_sw < 0:
                print(f"MISMATCH fps {(B, N, S)} at {geo}: picks differ beyond tie swaps")
                bad.append(f"fps {(B, N, S)} {geo}")
                continue
            ms = device_ms(run, iters)
            rows.append(dict(kernel="fps", shape=[B, N, S], c=c, threads=threads, ppt=ppt,
                             ms=ms, picked=geo == picked, tie_swaps=n_sw,
                             max_clusters=_max_clusters(N, c, threads, ppt)))
            if ms is None:
                print(f"    fps {geo}: device records incomplete, not measured")
            else:
                times[geo] = ms
        if picked not in times:
            continue
        best = min(times, key=times.get)
        line = (f"[fps] ({B}, {N}, 3)->{S}: picked C={picked[0]} threads={picked[1]} "
                f"ppt={picked[2]} {times[picked]:.5f} ms "
                f"({times[picked] * 1e3 / (S - 1):.4f} us a step); best {best} "
                f"{times[best]:.5f} ms")
        clock = sm_clock_mhz(lambda: ops.furthest_point_sample(pts, S))
        rows.append(dict(kernel="fps_clock", shape=[B, N, S], sm_clock_power=clock))
        print(line + f"; SM clock, power while it runs: {clock}", flush=True)
        for geo, t in sorted(times.items()):
            print(f"    C={geo[0]} threads={geo[1]} ppt={geo[2]}: {fmt(t)} ms", flush=True)
    for R, N, k in TOPK_SHAPES:
        d = torch.rand(R, N, generator=gen).to(dev)
        wv, wi = ops.k_smallest_ref(d, k)
        v, i = ops.k_smallest(d, k)
        if not (torch.equal(i, wi) and torch.equal(v, wv)):
            print(f"MISMATCH k_smallest {(R, N, k)}: differs from the plain version")
            bad.append(f"k_smallest {(R, N, k)}")
        t = device_ms(lambda: ops.k_smallest(d, k), 50)
        lib = device_ms(lambda: torch.topk(d, k, dim=-1, largest=False, sorted=True), 50)
        rows.append(dict(kernel="k_smallest", shape=[R, N, k], ms=t, library_ms=lib))
        print(f"[k_smallest] ({R}, {N}) k={k}: {fmt(t)} ms; torch.topk {fmt(lib)} ms", flush=True)
    for (B, N, M), swept in CHAMFER_SHAPES.items():
        x = torch.randn(B, N, 3, generator=gen).to(dev)
        y = torch.randn(B, M, 3, generator=gen).to(dev)
        want = {"chamfer_nn": ops.chamfer_ref(x, y), "chamfer_nn_min": ops.chamfer_min_ref(x, y)}
        picked = chamfer_mod.launch_geometry(B, N, M, sms)
        iters = 20 if B * N * M > 2 ** 26 else 100
        times = {}
        for geo in sorted(set(swept) | {picked}):
            for kind, run in chamfer_runs(x, y, geo).items():
                got = run()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want[kind])):
                    print(f"MISMATCH {kind} {(B, N, M)} at {geo}: differs from the plain version")
                    bad.append(f"{kind} {(B, N, M)} {geo}")
                    continue
                ms = device_ms(run, iters)
                rows.append(dict(kernel=kind, shape=[B, N, M], geometry=list(geo),
                                 picked=geo == picked, ms=ms))
                if ms is None:
                    print(f"    {kind} {geo}: device records incomplete, not measured")
                else:
                    times[kind, geo] = ms
        for kind in ("chamfer_nn", "chamfer_nn_min"):
            mine = {g: t for (k, g), t in times.items() if k == kind}
            if picked not in mine:
                continue
            best = min(mine, key=mine.get)
            print(f"[{kind}] ({B}, {N})x({B}, {M}): picked (tq, tt, r, threads, pack) = "
                  f"{picked} {mine[picked]:.5f} ms; best {best} {mine[best]:.5f} ms", flush=True)
            for geo, t in sorted(mine.items()):
                print(f"    {geo}: {fmt(t)} ms", flush=True)
    sweep_chamfer_bwd(dev, old, rows, bad)
    sweep_gumbel(dev, sms, rows, bad)
    sweep_gather(dev, old, rows, bad)
    sweep_row_gather(dev, old, rows, bad)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(f"wrote {args.out}", flush=True)
    if bad:
        raise SystemExit(f"kernel_sweep: outputs differ from the plain version: {bad}")


if __name__ == "__main__":
    main()
