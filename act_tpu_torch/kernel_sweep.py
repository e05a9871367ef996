"""Sweeps of the FPS and Chamfer kernels' launch geometries and times of the
k-smallest kernel on one CUDA card, beside an earlier version of the kernels.

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
prints the device times. With
``--parent DIR`` (a checkout that holds an earlier ``act_tpu_torch/csrc``),
that version's ``fps.cu``, ``topk.cu`` and ``chamfer.cu``, where they differ
from the current ones, are built too and timed at the same shapes in the same
process, in turns with the current ones.
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
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from act_tpu_torch import ops
from act_tpu_torch.ops import _backend
from act_tpu_torch.ops import chamfer as chamfer_mod
from act_tpu_torch.ops.fps import MAX_PPT, _max_clusters, _sms, launch_geometry, tie_swaps

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


def device_ms(fn, iters: int):
    """Summed device-kernel time of one call, averaged over ``iters`` calls;
    None when the profiler records no device kernel."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / iters if ev else None


# the earlier sources' launch functions: name, argument types
PARENT_FNS = {
    "fps": [("act_fps", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])],
    "topk": [("act_ksmallest", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])],
    "chamfer": [("act_chamfer_nn", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
                ("act_chamfer_nn_min",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])],
}


def build_parent(parent: Path) -> dict:
    """The earlier fps.cu, topk.cu and chamfer.cu that differ from the
    current ones, built as in ``_backend``, by launch function (PARENT_FNS
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/kernel_sweep.json"))
    args = ap.parse_args()
    dev = _backend.resolve_device("cuda")
    _backend.build_kernels(("fps", "k_smallest", "chamfer_nn"))
    for stem in ("fps", "topk", "chamfer"):
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
            times[geo] = device_ms(run, iters)
            rows.append(dict(kernel="fps", shape=[B, N, S], c=c, threads=threads, ppt=ppt,
                             ms=times[geo], per_step_us=times[geo] * 1e3 / (S - 1),
                             picked=geo == picked, tie_swaps=n_sw,
                             max_clusters=_max_clusters(N, c, threads, ppt)))
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
            line += f"; parent {t_old[0]:.5f}/{t_old[1]:.5f} ms, current {t_new:.5f} ms"
        clock = sm_clock_mhz(lambda: ops.furthest_point_sample(pts, S))
        rows.append(dict(kernel="fps_clock", shape=[B, N, S], sm_clock_power=clock))
        print(line + f"; SM clock, power while it runs: {clock}", flush=True)
        for geo, t in sorted(times.items()):
            print(f"    C={geo[0]} threads={geo[1]} ppt={geo[2]}: {t:.5f} ms", flush=True)
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
        line = f"[k_smallest] ({R}, {N}) k={k}: {t:.5f} ms; torch.topk {lib:.5f} ms"
        if "act_ksmallest" in old:
            ov = torch.empty(R, k, device=dev)
            oi = torch.empty(R, k, dtype=torch.int32, device=dev)
            t_old = [device_ms(lambda: call(old["act_ksmallest"], d, ov, oi, R, N, k), 50)]
            t_new = device_ms(lambda: ops.k_smallest(d, k), 50)
            t_old.append(device_ms(lambda: call(old["act_ksmallest"], d, ov, oi, R, N, k), 50))
            if not torch.equal(oi, wi):
                bad.append(f"parent k_smallest {(R, N, k)}")
            row.update(parent_ms=t_old, again_ms=t_new)
            line += f"; parent {t_old[0]:.5f}/{t_old[1]:.5f} ms, current again {t_new:.5f} ms"
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
                    print(f"    {kind} {geo}: no device kernel recorded, not measured")
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
                line += (f"; parent {t_old[0]:.5f}/{t_old[1]:.5f} ms, current "
                         f"{t_new[0]:.5f}/{t_new[1]:.5f} ms (parent, current, current, parent)")
            print(line, flush=True)
            for geo, t in sorted(mine.items()):
                print(f"    {geo}: {t:.5f} ms", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(f"wrote {args.out}", flush=True)
    if bad:
        raise SystemExit(f"kernel_sweep: outputs differ from the plain version: {bad}")


if __name__ == "__main__":
    main()
