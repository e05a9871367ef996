"""Sweeps of the FPS, Chamfer and Gumbel kernels' launch geometries and times
of the k-smallest kernel on one CUDA card, beside an earlier version of the
kernels.

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
prints the device times. It runs ``csrc/gumbel.cu`` at the Stage-II shape
(bf16 and f32) and at smaller and ragged ones, at each bucket count and grid
it sweeps and the one ``ops/sampling.py`` ``launch_geometry`` picks, checks
every run id for id against
``gumbel_argmax_ref`` (outputs filled with -1 before each checked run), and
prints the device times and the screen's survivors a row (from its plain
model ``sampling.screen_ref``). A device time that the profiler did not
record in full is reported as not measured (``act_tpu_torch/profiling.py``).
With ``--parent DIR`` (a checkout that holds an earlier
``act_tpu_torch/csrc``), that version's ``fps.cu``, ``topk.cu``,
``chamfer.cu`` and ``gumbel.cu``, where they differ from the current ones,
are built too and timed at the same shapes in the same process, in turns
with the current ones.
Writes every row as JSON to ``--out`` (default
``chiprun_out/kernel_sweep.json``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import torch

from act_tpu_torch import ops
from act_tpu_torch.ops import _backend
from act_tpu_torch.ops import chamfer as chamfer_mod
from act_tpu_torch.ops import sampling
from act_tpu_torch.ops.fps import MAX_PPT, _max_clusters, _sms, launch_geometry, tie_swaps
from act_tpu_torch.ops.reference import gumbel_chunk
from act_tpu_torch.profiling import device_ms

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


# the earlier sources' launch functions: name, argument types
PARENT_FNS = {
    "fps": [("act_fps", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])],
    "topk": [("act_ksmallest", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])],
    "chamfer": [("act_chamfer_nn", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
                ("act_chamfer_nn_min",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])],
    "gumbel": [("act_gumbel_argmax", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])],
}


def build_parent(parent: Path) -> dict:
    """The earlier fps.cu, topk.cu, chamfer.cu and gumbel.cu that differ from
    the current ones, built as in ``_backend``, by launch function (PARENT_FNS
    holds each one's signature before its redesign)."""
    out_dir = _backend.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in PARENT_FNS:
        src = parent / "act_tpu_torch" / "csrc" / f"{stem}.cu"
        if src.read_bytes() == (_backend.CSRC / f"{stem}.cu").read_bytes():
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
        for name, argtypes in PARENT_FNS[stem]:
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


def chamfer_runs(x: torch.Tensor, y: torch.Tensor, geo=None, old=None) -> dict:
    """Closures that launch ``chamfer_nn`` and ``chamfer_nn_min`` once and
    return their outputs: at tiling ``geo``, or the earlier source's
    functions ``old``."""
    (B, N, _), M = x.shape, y.shape[1]
    # NaN and -1 until a launch writes them: a launch that writes nothing fails the check
    d1, d2 = x.new_full((B, N), float("nan")), x.new_full((B, M), float("nan"))
    i1, i2 = (torch.full((B, n), -1, dtype=torch.int32, device=x.device) for n in (N, M))
    out = x.new_full((B * (N + M),), float("nan"))
    m1, m2 = out[:B * N].view(B, N), out[B * N:].view(B, M)
    if old is not None:
        def nn():
            call(old["act_chamfer_nn"], x, y, d1, i1, d2, i2, B, N, M)
            return d1, d2, i1, i2

        def nn_min():
            call(old["act_chamfer_nn_min"], x, y, m1, m2, B, N, M)
            return m1, m2
        return {"chamfer_nn": nn, "chamfer_nn_min": nn_min}
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


def sweep_gumbel(dev, sms: int, old: dict, rows: list, bad: list) -> None:
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
        if "act_gumbel_argmax" in old:
            def run_old():
                call(old["act_gumbel_argmax"], logits, seed, out, rows_, v,
                     gumbel_chunk(rows_, v), int(dtype == torch.bfloat16))
            out.fill_(-1)
            run_old()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                bad.append(f"parent gumbel_argmax {shape}")
            t_old = [device_ms(run_old, iters)]
            t_new = [device_ms(lambda: ops.gumbel_argmax(logits, seed), iters) for _ in range(2)]
            t_old.append(device_ms(run_old, iters))
            rows.append(dict(kernel="gumbel_argmax_parent", shape=[rows_, v, str(dtype)],
                             ms=t_old, new_ms=t_new))
            line += (f"; parent {fmt(t_old[0])}/{fmt(t_old[1])} ms, current "
                     f"{fmt(t_new[0])}/{fmt(t_new[1])} ms (parent, current, current, parent)")
        if rows_ * v > 2 ** 22:
            clock = sm_clock_mhz(lambda: ops.gumbel_argmax(logits, seed))
            rows.append(dict(kernel="gumbel_clock", shape=[rows_, v, str(dtype)],
                             sm_clock_power=clock))
            line += f"; SM clock, power while it runs: {clock}"
        print(line, flush=True)
        for geo, t in sorted(times.items()):
            print(f"    {geo}: {fmt(t)} ms", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/kernel_sweep.json"))
    args = ap.parse_args()
    dev = _backend.resolve_device("cuda")
    _backend.build_kernels(("fps", "k_smallest", "chamfer_nn", "gumbel_argmax"))
    for stem in ("fps", "topk", "chamfer", "gumbel"):
        for line in _backend.BUILD_LOG.get(stem, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {stem}: {line.strip()}")
    old = build_parent(args.parent) if args.parent else {}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
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
        if "act_fps" in old:
            def run_old():
                call(old["act_fps"], pts, start, out, B, N, S)
            run_old()
            torch.cuda.synchronize()
            if tie_swaps(out, want) < 0:
                bad.append(f"parent fps {(B, N, S)}")
            t_old = [device_ms(run_old, iters)]
            t_new = device_ms(lambda: ops.furthest_point_sample(pts, S), iters)
            t_old.append(device_ms(run_old, iters))
            rows.append(dict(kernel="fps_parent", shape=[B, N, S], ms=t_old,
                             new_ms=t_new))
            line += f"; parent {fmt(t_old[0])}/{fmt(t_old[1])} ms, current {fmt(t_new)} ms"
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
        row = dict(kernel="k_smallest", shape=[R, N, k], ms=t, library_ms=lib)
        line = f"[k_smallest] ({R}, {N}) k={k}: {fmt(t)} ms; torch.topk {fmt(lib)} ms"
        if "act_ksmallest" in old:
            ov = torch.empty(R, k, device=dev)
            oi = torch.empty(R, k, dtype=torch.int32, device=dev)
            t_old = [device_ms(lambda: call(old["act_ksmallest"], d, ov, oi, R, N, k), 50)]
            t_new = device_ms(lambda: ops.k_smallest(d, k), 50)
            t_old.append(device_ms(lambda: call(old["act_ksmallest"], d, ov, oi, R, N, k), 50))
            if not torch.equal(oi, wi):
                bad.append(f"parent k_smallest {(R, N, k)}")
            row.update(parent_ms=t_old, again_ms=t_new)
            line += f"; parent {fmt(t_old[0])}/{fmt(t_old[1])} ms, current again {fmt(t_new)} ms"
        rows.append(row)
        print(line, flush=True)
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
        old_runs = chamfer_runs(x, y, old=old) if "act_chamfer_nn" in old else {}
        for kind in ("chamfer_nn", "chamfer_nn_min"):
            mine = {g: t for (k, g), t in times.items() if k == kind}
            if picked not in mine:
                continue
            best = min(mine, key=mine.get)
            line = (f"[{kind}] ({B}, {N})x({B}, {M}): picked (tq, tt, r, threads, pack) = "
                    f"{picked} {mine[picked]:.5f} ms; best {best} {mine[best]:.5f} ms")
            if kind in old_runs:
                got = old_runs[kind]()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want[kind])):
                    bad.append(f"parent {kind} {(B, N, M)}")
                current = chamfer_mod.nn_pair if kind == "chamfer_nn" else chamfer_mod.nn_pair_min
                t_old = [device_ms(old_runs[kind], iters)]
                t_new = [device_ms(lambda: current(x, y), iters) for _ in range(2)]
                t_old.append(device_ms(old_runs[kind], iters))
                rows.append(dict(kernel=f"{kind}_parent", shape=[B, N, M], ms=t_old,
                                 new_ms=t_new))
                line += (f"; parent {fmt(t_old[0])}/{fmt(t_old[1])} ms, current "
                         f"{fmt(t_new[0])}/{fmt(t_new[1])} ms (parent, current, current, parent)")
            print(line, flush=True)
            for geo, t in sorted(mine.items()):
                print(f"    {geo}: {fmt(t)} ms", flush=True)
    sweep_gumbel(dev, sms, old, rows, bad)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(f"wrote {args.out}", flush=True)
    if bad:
        raise SystemExit(f"kernel_sweep: outputs differ from the plain version: {bad}")


if __name__ == "__main__":
    main()
