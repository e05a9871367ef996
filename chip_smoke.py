#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one CUDA card.

  python3 chip_smoke.py        # from the repository root

Builds the port's CUDA kernels from ``act_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version at the serving shapes, serves the
full-width ModelNet classifier (``finetune_modelnet.yaml``: 384 x 12, G=64,
M=32, 40 classes, bf16, seeded weights) on (32, 8192, 3) clouds through
``build_infer_fn`` and through ``serve_http``, and times the kernels, their
plain versions, the matching library calls and the requests.

Every phase that fails makes the process exit non-zero. Without a card, or
without the port beside it, the script exits non-zero and prints no result.
The last three lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = "cfgs/finetune_classification/full/finetune_modelnet.yaml"
B, N_IN = 32, 8192  # ModelNet requests carry 8192 points (ModelNet40.yaml)
HTTP_BATCH, HTTP_REQUESTS = 4, 3
LOGIT_ATOL = 0.05  # bf16 logits, kernel path vs plain path (see phase 3)
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
REPLACES = {"fps": "act_tpu/ops/fps.py:98", "k_smallest": "act_tpu/ops/topk.py:33",
            "gather": "act_tpu/ops/gather.py:25"}
SOURCES = {"fps": "act_tpu_torch/csrc/fps.cu", "k_smallest": "act_tpu_torch/csrc/topk.cu",
           "gather": "act_tpu_torch/csrc/gather.cu"}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, f32_ops: float = 0.0):
    """Least time for the work: the larger of bytes over the memory rate and
    f32 operations over the f32 rate. Returns (ms, 'bytes' | 'operations')."""
    tb, to = nbytes / PEAK_BYTES_S, f32_ops / PEAK_F32_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def distinct_rows(idx) -> int:
    """Rows of the table that a (B, S) gather reads: its distinct indices,
    counted per cloud."""
    s = idx.reshape(idx.shape[0], -1).sort(-1).values
    return int(s.shape[0] * (s.shape[1] > 0) + (s[:, 1:] != s[:, :-1]).sum().item())


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from act_tpu_torch import ops
        from act_tpu_torch.engine.serve import build_infer_fn, load_config, load_model
        from act_tpu_torch.ops import _backend
        from act_tpu_torch.ops.fps import tie_swaps
        from act_tpu_torch.serve_http import make_server
    except ImportError as e:
        fail(f"the act_tpu_torch package is not beside this script ({e})")
    os.chdir(ROOT)  # the configs' _base_ paths are relative to the repo root
    dev = _backend.resolve_device("cuda")
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _backend.build_kernels()
    print(f"[build] 3 kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in _backend.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    def timed(fn, iters, warm=3):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    # -- 2. kernels vs plain versions at the path shapes ---------------------
    gen = torch.Generator().manual_seed(0)
    clouds = torch.randn(B, N_IN, 3, generator=gen).to(dev)
    cfg = load_config(CONFIG)
    npoints, G, M = int(cfg.npoints), int(cfg.model.num_group), int(cfg.model.group_size)
    errs = {}
    with torch.inference_mode():
        k_rs = ops.furthest_point_sample(clouds, npoints)
        r_rs = ops.furthest_point_sample_ref(clouds, npoints)
        pts = ops.gather_points(clouds, r_rs)  # the resampled clouds, plain path
        k_c = ops.furthest_point_sample(pts, G)
        r_c = ops.furthest_point_sample_ref(pts, G)
        centers = ops.gather_points(pts, r_c)
        d = ops.square_distance(centers, pts).reshape(B * G, npoints)
        k_v, k_i = ops.k_smallest(d, M)
        r_v, r_i = ops.k_smallest_ref(d, M)
        nbr_idx = r_i.reshape(B, G * M)
        g_pairs = [(clouds, r_rs), (pts, r_c), (pts, nbr_idx)]
        g_out = [(ops.gather_coords(p, i), ops.gather_points(p, i)) for p, i in g_pairs]
        torch.cuda.synchronize()
    for tag, k, r, p in (("8192->1024", k_rs, r_rs, clouds), ("1024->64", k_c, r_c, pts)):
        n_sw = tie_swaps(k, r)
        if n_sw < 0:
            fail(f"fps {tag}: kernel picks differ from the plain version beyond tie swaps")
        same_set = torch.equal(k.sort(-1).values, r.sort(-1).values)
        if not same_set:
            fail(f"fps {tag}: selected sets differ")
        err = (ops.gather_points(p, k) - ops.gather_points(p, r)).abs().max().item()
        errs[f"fps {tag}"] = err
        print(f"[check] fps {tag}: indices equal up to {n_sw} adjacent tie swaps, "
              f"same set; max |coord diff| {err}", flush=True)
    if not torch.equal(k_i, r_i):
        fail("k_smallest: indices differ from the plain version")
    errs["k_smallest"] = (k_v - r_v).abs().max().item()
    if errs["k_smallest"] > 1e-6:
        fail(f"k_smallest: values differ by {errs['k_smallest']} > 1e-6")
    print(f"[check] k_smallest ({B * G}, {npoints}) k={M}: indices equal, "
          f"max |value diff| {errs['k_smallest']} (tolerance 1e-6)", flush=True)
    errs["gather"] = 0.0
    for (p, i), (k, r) in zip(g_pairs, g_out):
        if not torch.equal(k, r):
            fail(f"gather {tuple(p.shape)} by {tuple(i.shape)}: not bit-equal")
        errs["gather"] = max(errs["gather"], (k - r).abs().max().item())
    print("[check] gather: bit-equal at " + ", ".join(
        f"{tuple(p.shape)} by {tuple(i.shape)}" for p, i in g_pairs), flush=True)

    # -- 3. the full-width classifier through build_infer_fn -----------------
    t0 = time.perf_counter()
    model = load_model(cfg, seed=0, device=dev)
    infer = build_infer_fn(model, npoints)
    print(f"[model] {CONFIG}: {sum(p.numel() for p in model.parameters())} params, "
          f"dtype {cfg.model.get('dtype')}, built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    infer(clouds[:2])  # warm-up (cuBLAS handles), not counted
    torch.cuda.synchronize()
    _backend.reset_launches()
    logits = infer(clouds)
    torch.cuda.synchronize()
    launches = dict(_backend.LAUNCHES)
    print(f"[path] launches in one B={B} request: {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if tuple(logits.shape) != (B, int(cfg.model.cls_dim)) or not torch.isfinite(logits).all():
        fail(f"logits: shape {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    with torch.inference_mode():
        pts_plain = ops.gather_points(clouds, ops.furthest_point_sample_ref(clouds, npoints))
        plain = model.forward_grouped(*ops.group_points_ref(pts_plain, G, M))
    diff = (logits - plain).abs().max().item()
    agree = torch.equal(logits.argmax(-1), plain.argmax(-1))
    print(f"[path] logits vs the plain-version forward: max |diff| {diff} "
          f"(tolerance {LOGIT_ATOL}), argmax agree {agree}", flush=True)
    if not agree or diff > LOGIT_ATOL:
        fail("classifier: kernel path and plain path disagree")

    # -- 4. serving over HTTP ------------------------------------------------
    meta = {"kind": "classifier", "npoints": npoints, "cls_dim": int(cfg.model.cls_dim)}
    server = make_server(infer, meta, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/predict"
        for r in range(HTTP_REQUESTS):
            batch = clouds[r * HTTP_BATCH:(r + 1) * HTTP_BATCH]
            body = json.dumps({"points": batch.cpu().tolist()}).encode()
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                            timeout=120) as resp:
                    code, payload = resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                fail(f"http request {r}: status {e.code} {e.read()[:500]!r}")
            ms = (time.perf_counter() - t0) * 1e3
            want = infer(batch).argmax(-1).tolist()
            print(f"[http] request {r}: {code}, argmax {payload['argmax']} "
                  f"(direct {want}), {ms:.1f} ms with JSON", flush=True)
            if code != 200 or payload["argmax"] != want:
                fail(f"http request {r}: status {code}, argmax differs from the direct call")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    # -- 5. times on the card -------------------------------------------------
    # A kernel's time is its device time from torch.profiler (CUPTI): at these
    # sizes a call's CUDA-event time is the host's dispatch time, which is
    # printed beside it as "per call".
    print(f"[time] card: {card}", flush=True)

    def kernel_events(fn, iters):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    def device_ms(fn, iters):
        """Summed duration of the device kernels a call runs, averaged over
        iters calls; None when the profiler records no device kernel."""
        ev = kernel_events(fn, iters)
        return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / iters if ev else None

    def measure(shape, fn, plain, library, iters, plain_iters, bound):
        call = timed(fn, iters)
        dev_ms = device_ms(fn, iters)
        return dict(shape=shape, ms=call if dev_ms is None else dev_ms, call_ms=call,
                    timing="cuda_events" if dev_ms is None else "profiler",
                    plain_ms=device_ms(plain, plain_iters) or timed(plain, plain_iters, 1),
                    library_ms=None if library is None else
                    (device_ms(library, iters) or timed(library, iters)),
                    bound=bound)

    with torch.inference_mode():
        d_pts = pts.contiguous()
        gi = [(p.contiguous(), i.contiguous()) for p, i in g_pairs]
        long_idx = [i.long().reshape(B, -1, 1).expand(-1, -1, p.shape[-1]).contiguous()
                    for p, i in gi]
        shapes = {
            "fps": [
                measure(f"({B}, {N_IN}, 3)->{npoints}",
                        lambda: ops.furthest_point_sample(clouds, npoints),
                        lambda: ops.furthest_point_sample_ref(clouds, npoints), None, 20, 1,
                        bound_ms(clouds.numel() * 4 + B * npoints * 4,
                                 10.0 * B * (npoints - 1) * N_IN)),
                measure(f"({B}, {npoints}, 3)->{G}",
                        lambda: ops.furthest_point_sample(d_pts, G),
                        lambda: ops.furthest_point_sample_ref(d_pts, G), None, 50, 3,
                        bound_ms(d_pts.numel() * 4 + B * G * 4,
                                 10.0 * B * (G - 1) * npoints)),
            ],
            "k_smallest": [
                measure(f"({B * G}, {npoints}) k={M}", lambda: ops.k_smallest(d, M),
                        lambda: ops.k_smallest_ref(d, M),
                        lambda: torch.topk(d, M, dim=-1, largest=False, sorted=True), 100, 20,
                        bound_ms(d.numel() * 4 + B * G * M * 8, d.numel())),
            ],
            "gather": [
                measure(f"{tuple(p.shape)} by {tuple(i.shape)}, {distinct_rows(i)} rows read",
                        lambda p=p, i=i: ops.gather_coords(p, i),
                        lambda p=p, i=i: ops.gather_points(p, i),
                        lambda p=p, li=li: torch.gather(p, 1, li), 200, 200,
                        bound_ms(distinct_rows(i) * p.shape[-1] * 4 + i.numel() * 4
                                 + i.numel() * p.shape[-1] * 4))
                for (p, i), li in zip(gi, long_idx)
            ],
        }
    for name, rows in shapes.items():
        for r in rows:
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
            print(f"[time] {name} {r['shape']}: kernel {r['ms']:.5f} ms ({r['timing']}; "
                  f"{r['call_ms']:.5f} ms per call), plain {r['plain_ms']:.5f} ms, "
                  f"library {lib} ms, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})",
                  flush=True)

    def request_ms(batch, iters):
        for _ in range(3):
            infer(batch)
        torch.cuda.synchronize()
        out = []
        for _ in range(iters):
            t0 = time.perf_counter()
            infer(batch)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    for bs, iters in ((1, 30), (B, 20)):
        lat = request_ms(clouds[:bs], iters)
        med = statistics.median(lat)
        ev = kernel_events(lambda: infer(clouds[:bs]), 5)
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3 / 5
        by_name = {}
        for e in ev:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / 5
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        dev_txt = (f"device busy {busy:.3f} ms a request ({len(ev) // 5} kernels), "
                   f"idle share {1 - busy / med:.3f}" if ev else "device busy not measured")
        print(f"[time] request B={bs} ({N_IN} points each): median {med:.3f} ms, "
              f"min {min(lat):.3f}, max {max(lat):.3f} over {iters}; "
              f"{bs / med * 1e3:.1f} clouds/s; {dev_txt}", flush=True)
        print(f"[time] request B={bs} top kernels (ms a request): "
              + "; ".join(f"{n[:60]} {t:.4f}" for n, t in top), flush=True)

    stage = {}
    with torch.inference_mode():
        stage["resample (fps + gather)"] = lambda: ops.gather_coords(
            clouds, ops.furthest_point_sample(clouds, npoints))
        stage["group_points"] = lambda: ops.group_points(d_pts, G, M)
        nbr, ctr = ops.group_points(d_pts, G, M)
        stage["model after grouping"] = lambda: model.forward_grouped(nbr, ctr)
        stage_ms = {k: (device_ms(fn, 5), timed(fn, 10)) for k, fn in stage.items()}
    print(f"[time] B={B} stages (device ms, per-call ms): " + ", ".join(
        f"{k} {dv if dv is None else round(dv, 5)}, {c:.5f}" for k, (dv, c) in stage_ms.items()),
        flush=True)

    record = []
    for name, rows in shapes.items():
        record.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(v for k, v in errs.items() if k.startswith(name)),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound"][0] for r in rows),
            "bound_by": rows[0]["bound"][1],
            "library_ms": (None if rows[0]["library_ms"] is None
                           else sum(r["library_ms"] for r in rows)),
            "timing": rows[0]["timing"],
            "per_launch": [{"shape": r["shape"], "ms": r["ms"], "call_ms": r["call_ms"],
                            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                            "library_ms": r["library_ms"]} for r in rows],
        })
    print(json.dumps({"kernels": record}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
