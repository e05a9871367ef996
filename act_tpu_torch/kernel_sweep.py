"""Sweep of the FPS kernel's launch geometry and times of the k-smallest kernel
on one CUDA card, beside an earlier version of both kernels.

  python -m act_tpu_torch.kernel_sweep [--parent DIR] [--out FILE]

For each FPS shape of the port's paths it runs ``csrc/fps.cu`` at every
cluster size (1, 2, 4, 8) and the points a thread (1-16) that keep a block
small, checks the picks against the plain version (equal up to adjacent tie
swaps) and prints the profiler device time of each geometry beside the one
``launch_geometry`` picks, and the SM clock while the picked one runs. It times ``csrc/topk.cu`` at the path's shapes against its plain
version (indices equal, values bit-equal) and ``torch.topk``. With
``--parent DIR`` (a checkout that holds an earlier ``act_tpu_torch/csrc``),
that version's ``fps.cu`` and ``topk.cu`` are built too and timed at the
same shapes in the same process, in turns with the current ones.
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
from act_tpu_torch.ops.fps import MAX_PPT, _max_clusters, _sms, launch_geometry, tie_swaps

# the serving resample at B=32 and B=1, Stage II's centers (Stage I's at B=64
# take the same geometry), the SVM probe's resample, the largest clouds
FPS_SHAPES = [(32, 8192, 1024), (1, 8192, 1024), (128, 1024, 64), (256, 8192, 1024),
              (8, 16384, 512)]
TOPK_SHAPES = [(8192, 1024, 32), (8192, 64, 4), (2048, 1024, 32), (4096, 1024, 32),
               (4096, 64, 4)]


def device_ms(fn, iters: int) -> float:
    """Summed device-kernel time of one call, averaged over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / iters


def build_parent(parent: Path) -> dict:
    """The earlier fps.cu and topk.cu, built as in ``_backend``, by kernel."""
    out_dir = _backend.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in ("fps", "topk"):
        so = out_dir / f"{stem}.so"
        cmd = [_backend._nvcc(), *_backend.NVCC_FLAGS, "-o", str(so),
               str(parent / "act_tpu_torch" / "csrc" / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for stem, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent {stem}.cu failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, {"fps": "act_fps", "topk": "act_ksmallest"}[stem])
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[stem] = fn
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/kernel_sweep.json"))
    args = ap.parse_args()
    dev = _backend.resolve_device("cuda")
    _backend.build_kernels(("fps", "k_smallest"))
    for stem in ("fps", "topk"):
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
        if "fps" in old:
            def run_old():
                call(old["fps"], pts, start, out, B, N, S)
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
        if "topk" in old:
            ov = torch.empty(R, k, device=dev)
            oi = torch.empty(R, k, dtype=torch.int32, device=dev)
            t_old = [device_ms(lambda: call(old["topk"], d, ov, oi, R, N, k), 50)]
            t_new = device_ms(lambda: ops.k_smallest(d, k), 50)
            t_old.append(device_ms(lambda: call(old["topk"], d, ov, oi, R, N, k), 50))
            if not torch.equal(oi, wi):
                bad.append(f"parent k_smallest {(R, N, k)}")
            row.update(parent_ms=t_old, again_ms=t_new)
            line += f"; parent {t_old[0]:.5f}/{t_old[1]:.5f} ms, current again {t_new:.5f} ms"
        rows.append(row)
        print(line, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(f"wrote {args.out}", flush=True)
    if bad:
        raise SystemExit(f"kernel_sweep: outputs differ from the plain version: {bad}")


if __name__ == "__main__":
    main()
