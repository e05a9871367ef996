#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one CUDA card.

  python3 chip_smoke.py        # from the repository root

Builds the port's CUDA kernels from ``act_tpu_torch/csrc`` and drives both of
the port's paths at full width, each kernel held against its plain PyTorch
version at the shapes the path gives it:

- serving: the ModelNet classifier (``finetune_modelnet.yaml``: 384 x 12,
  G=64, M=32, 40 classes, bf16, seeded weights) on (32, 8192, 3) clouds
  through ``build_infer_fn`` and through ``serve_http``;
- Stage-II pretraining: ``ACT_PointDistillation`` at
  ``pretrain_act_distill.yaml`` (B=128 clouds of 1024 points, the 384 x 12
  student, the frozen tokenizer with the prompted ViT-B teacher, bf16,
  seeded weights, synthetic clouds): one eval forward through the kernels
  and one through the plain versions, then ``run_steps`` for a few train
  steps;
- Stage-I autoencoder training: ``ACTPromptedDiscreteVAEwithVIT`` at
  ``act_dvae_with_pretrained_transformer.yaml`` (B=64 clouds of 1024 points,
  G=64 x M=32, 384 wide, an 8192-way codebook, the frozen ViT-B teacher with
  64 deep prompts, bf16, seeded weights, synthetic clouds): the Chamfer
  kernels against their plain versions, one train-mode loss and backward
  through the kernels and one through the plain versions, then
  ``run_autoencoder_steps`` for a few train steps and ``validate`` (the
  reconstruction metrics);

and times the kernels, their plain versions, the matching library calls, the
requests and the train steps.

Every phase that fails makes the process exit non-zero. Without a card, or
without the port beside it, the script exits non-zero and prints no result.
The last three lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = "cfgs/finetune_classification/full/finetune_modelnet.yaml"
PRETRAIN_CONFIG = "cfgs/pretrain/pretrain_act_distill.yaml"
B, N_IN = 32, 8192  # ModelNet requests carry 8192 points (ModelNet40.yaml)
HTTP_BATCH, HTTP_REQUESTS = 4, 3
LOGIT_ATOL = 0.05  # bf16 logits, kernel path vs plain path (see phase 3)
# bf16 Stage-II loss, kernel path vs plain path: the two differ only if an
# FPS tie swap reorders the groups (see phase 7)
LOSS_ATOL = 1e-3
WARM_STEPS, TIMED_STEPS = 3, 10
AUTOENCODER_CONFIG = "cfgs/autoencoder/act_dvae_with_pretrained_transformer.yaml"
S1_WARM_STEPS, S1_TIMED_STEPS = 3, 5
S1_START_ITR = 60000  # the anneals there: temperature below 1, KLD weight 0.05
VAL_CLOUDS = 8
WHOLE_CLOUD = (32, 2048)  # the JAX package's own Chamfer op shape (tools/bench_suite.py:587)
# chamfer_bwd on clouds of more than 32 points (the atomic body) against its
# plain version: atomicAdd sums in a changing order, so within 1e-5 of the
# largest |gradient|. Clouds of at most 32 points (the group body, both recon
# calls) are held to the plain version run on the CPU bit for bit.
BWD_RTOL = 1e-5
# full-width bf16 gradients, kernel path against plain path (phase 12), in
# relative L2 norm. The plain path's Chamfer backward (index_add_ on the card)
# sums in another order than the kernel's ascending one. On the loss's side of
# the bf16 teacher (the decoder, dgcnn_2) that leaves the gradients within
# GRAD_RTOL, and two kernel-path runs are equal there.
# Upstream of it every bf16 rounding through its 12 frozen blocks can move an
# element by one bf16 ulp (2^-8), and two kernel-path runs still differ by
# about 1 % (measured on the H100, printed by the phase; the port's kernels
# give the same outputs from run to run, so the spread comes from PyTorch's
# own operators there): the gap to the plain path is held to SPREAD_FACTOR
# times that run-to-run spread, and never below GRAD_RTOL.
GRAD_RTOL = 1e-3
SPREAD_FACTOR = 2.0
DOWNSTREAM_KEYS = ("decoder.final_conv.6.weight", "decoder.mlp.0.weight",
                   "dgcnn_2.layer5.0.weight")
UPSTREAM_KEYS = ("visual_prompt_token", "codebook", "dgcnn_1.layer5.0.weight",
                 "encoder.first_conv.0.weight")
METRIC_RTOL = 1e-4  # validation metrics, kernel path against plain path (phase 14)
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
GUMBEL_OPS = 24  # operations an element, counted in the note of csrc/gumbel.cu
# operations a pair: 8 for its squared distance (3 subtractions, 3 products,
# 2 sums), computed once as the function needs it, and 1 compare a direction
CHAMFER_OPS = 10
CHAMFER_BWD_OPS = 15  # operations a point: 3 subtractions, 6 products, 6 sums
# the TPU kernel (its pallas_call function) that each port kernel replaces
REPLACES = {"fps": "act_tpu/ops/fps.py:98", "k_smallest": "act_tpu/ops/topk.py:33",
            "gather": "act_tpu/ops/gather.py:25", "gumbel_argmax": "act_tpu/ops/sampling.py:50",
            "chamfer_nn": "act_tpu/ops/chamfer.py:33",
            "chamfer_nn_min": "act_tpu/ops/chamfer.py:167",
            "chamfer_bwd": "act_tpu/ops/chamfer.py:341 (_chamfer_bwd)"}
SERVE_KERNELS = ("fps", "k_smallest", "gather")  # the kernels of the serving path
# kernel launches a train step (or a validation cloud) of each training path
STAGE2_PER_STEP = {"fps": 1, "k_smallest": 3, "gather": 2, "gumbel_argmax": 1}
STAGE1_PER_STEP = {"fps": 1, "k_smallest": 3, "gather": 2, "chamfer_nn": 2, "chamfer_bwd": 2}
VALIDATE_PER_CLOUD = {"fps": 1, "k_smallest": 3, "gather": 2, "chamfer_nn_min": 1}
# TPU kernels that a port kernel of another name covers: row -> (kernel, replaces)
COVERED = {"fps_start0": ("fps", "act_tpu/ops/fps.py:29")}


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


def print_times(prefix: str, rows_by_kernel) -> None:
    """One ``[time]`` line for each launch shape that ``measure`` timed."""
    for name, rows in rows_by_kernel.items():
        for r in rows:
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
            print(f"[time] {prefix}{name} {r['shape']} (x{r['n']}): kernel {r['ms']:.5f} ms "
                  f"({r['timing']}; {r['call_ms']:.5f} ms per call), plain "
                  f"{r['plain_ms']:.5f} ms, library {lib} ms, bound {r['bound'][0]:.5f} ms "
                  f"({r['bound'][1]})", flush=True)


def check_launches(tag: str, launches, per_unit, units: int) -> None:
    """Fail unless ``launches`` are ``units`` times ``per_unit`` (0 elsewhere)."""
    want = {k: per_unit.get(k, 0) * units for k in launches}
    if launches != want:
        fail(f"{tag}: kernel launches {launches}, expected {want}")


def chamfer_bounds(x, y, index: bool):
    """``bound_ms`` of one chamfer_nn (``index``) or chamfer_nn_min launch:
    both clouds read, distances (and indices) written, ``CHAMFER_OPS``
    operations a pair."""
    (B, N, _), M = x.shape, y.shape[1]
    out = (8 if index else 4) * B * (N + M)
    return bound_ms(12 * B * (N + M) + out, CHAMFER_OPS * float(B * N * M))


def chamfer_bwd_bounds(x, y):
    """``bound_ms`` of one chamfer_bwd launch: x, y, the indices and the
    output gradients read, dx, dy written."""
    (B, N, _), M = x.shape, y.shape[1]
    return bound_ms(12 * B * (N + M) * 2 + 8 * B * (N + M), CHAMFER_BWD_OPS * B * (N + M))


def distinct_rows(idx) -> int:
    """Rows of the table that a (B, S) gather reads: its distinct indices,
    counted per cloud."""
    s = idx.reshape(idx.shape[0], -1).sort(-1).values
    return int(s.shape[0] * (s.shape[1] > 0) + (s[:, 1:] != s[:, :-1]).sum().item())


@contextmanager
def patched(module, **attrs):
    """Set attributes of ``module`` for the ``with`` block, then restore them."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def stage_two(dev, device_ms, kernel_events, measure):
    """Phases 6-10: the Stage-II kernels against their plain versions at the
    path's shapes, the full-width model's eval forward through the kernels
    and through the plain versions, ``run_steps``, and the kernel times.
    Returns (timing rows by kernel, errors, launches of the run_steps run)."""
    import torch
    from act_tpu_torch import ops
    from act_tpu_torch.datasets import synthetic_batch
    from act_tpu_torch.engine import builder
    from act_tpu_torch.engine.runner_pretrain import TOKENIZER, build_pretrain_model, run_steps
    from act_tpu_torch.engine.serve import load_config
    from act_tpu_torch.engine.train_state import pretrain_step, step_rngs
    from act_tpu_torch.models.teacher import teacher_forward
    from act_tpu_torch.ops import _backend, sampling
    from act_tpu_torch.ops.fps import _sms, tie_swaps

    cfg = load_config(PRETRAIN_CONFIG)
    bs, npts = int(cfg.total_bs), int(cfg.dataset.train.others.npoints)
    dc = cfg.model.dvae_config
    G, M, V = int(dc.num_group), int(dc.group_size), int(dc.num_tokens)
    errs = {}

    # -- 6. the Gumbel kernel against its plain version, (B*G, V) bf16 --------
    g = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn(bs * G, V, generator=g, device=dev).to(torch.bfloat16)
    seeds = [torch.tensor(w, dtype=torch.int32, device=dev) for w in ([0, 1], [123456789, -5])]
    with torch.inference_mode():
        for seed in seeds:
            k, r = ops.gumbel_argmax(logits, seed), ops.gumbel_argmax_ref(logits, seed)
            pert = ops.gumbel_perturbed_ref(logits, seed)
            bad = (k != r).nonzero().flatten()
            tag = f"gumbel_argmax seed {seed.tolist()}"
            if bad.numel():
                top2 = pert[bad].topk(2, dim=-1).values
                for i, row in enumerate(bad[:20].tolist()):
                    print(f"[check] {tag}: row {row} kernel {int(k[row])} plain {int(r[row])} "
                          f"top-two gap {float(top2[i, 0] - top2[i, 1])}", flush=True)
                fail(f"{tag}: {bad.numel()} of {k.numel()} ids differ from the plain version")
            # the picked perturbed values; a lane whose draw rounds to u = 1
            # carries +inf noise (about 2 lanes in 8192 x 8192), so equal ids
            # count as 0 rather than inf - inf
            picked = [pert.gather(1, ids.long()[:, None]) for ids in (k, r)]
            errs[tag] = float(torch.where((k == r)[:, None], 0.0,
                                          (picked[0] - picked[1]).abs()).max())
            n_inf = int(torch.isposinf(pert).sum())
            print(f"[check] {tag} ({bs * G}, {V}) bf16: ids equal (tolerance: exact); "
                  f"{n_inf} lanes drew u = 1 (+inf noise)", flush=True)
        # the screen's bound, then constructed ties, near ties, NaN and +-inf rows
        geo = sampling.launch_geometry(bs * G, V, _sms(dev.index or 0))
        if sampling.bound_violations(geo[0], dev) != (0, 0):
            fail(f"gumbel_argmax: the noise leaves its bucket bounds at k = {geo[0]}")
        hard, hard_seed, cases = sampling.gumbel_cases(bs * G, V, torch.bfloat16, dev)
        k, r = ops.gumbel_argmax(hard, hard_seed), ops.gumbel_argmax_ref(hard, hard_seed)
        wrong = sampling.check_gumbel_cases(k, r, cases)
        if not torch.equal(k, r) or wrong:
            fail(f"gumbel_argmax hard rows: {int((k != r).sum())} ids differ from the plain "
                 f"version; cases wrong: {wrong}")
        errs[f"gumbel_argmax hard rows seed {hard_seed.tolist()}"] = 0.0
        print(f"[check] gumbel_argmax geometry (k, blocks) = {geo}; noise "
              f"within its bucket bounds for all 2^31 bits; {len(cases)} hard rows at "
              f"({bs * G}, {V}) bf16, seed {hard_seed.tolist()}, ids equal the plain version's "
              f"and each case's own (tolerance: exact): {', '.join(cases)}", flush=True)

    # -- 7. the other kernels at the Stage-II shapes; FPS at start 0 ----------
    clouds = torch.from_numpy(synthetic_batch(0, bs, npts)).to(dev)
    with torch.inference_mode():
        kc, rc = ops.furthest_point_sample(clouds, G), ops.furthest_point_sample_ref(clouds, G)
        n_sw = tie_swaps(kc, rc)
        if n_sw < 0 or not torch.equal(kc.sort(-1).values, rc.sort(-1).values):
            fail(f"fps ({bs}, {npts}, 3)->{G}: kernel picks differ beyond tie swaps")
        errs[f"fps {bs}x{npts}->{G}"] = float(
            (ops.gather_points(clouds, kc) - ops.gather_points(clouds, rc)).abs().max())
        print(f"[check] fps ({bs}, {npts}, 3)->{G}: equal up to {n_sw} adjacent tie swaps",
              flush=True)
        centers = ops.gather_points(clouds, rc)
        d_grp = ops.square_distance(centers, clouds).reshape(bs * G, npts)
        d_dg = ops.square_distance(centers, centers).reshape(bs * G, G)
        for d, kk in ((d_grp, M), (d_dg, 4)):
            (kv, ki), (rv, ri) = ops.k_smallest(d, kk), ops.k_smallest_ref(d, kk)
            err = float((kv - rv).abs().max())
            if not torch.equal(ki, ri) or err > 1e-6:
                fail(f"k_smallest {tuple(d.shape)} k={kk}: differs from the plain version")
            errs[f"k_smallest {tuple(d.shape)} k={kk}"] = err
            print(f"[check] k_smallest {tuple(d.shape)} k={kk}: indices equal, "
                  f"max |value diff| {err} (tolerance 1e-6)", flush=True)
        nbr_idx = ops.k_smallest_ref(d_grp, M)[1].reshape(bs, G * M)
        gathers = [(clouds, rc), (clouds, nbr_idx)]
        for p, i in gathers:
            if not torch.equal(ops.gather_coords(p, i), ops.gather_points(p, i)):
                fail(f"gather {tuple(p.shape)} by {tuple(i.shape)}: not bit-equal")
            errs[f"gather {tuple(i.shape)}"] = 0.0
        print("[check] gather: bit-equal at " + ", ".join(
            f"{tuple(p.shape)} by {tuple(i.shape)}" for p, i in gathers), flush=True)
        # act_tpu/ops/fps.py:29 _fps_kernel: row-per-program FPS from index 0
        # with the first argmax, covered by csrc/fps.cu at start 0
        gen = torch.Generator().manual_seed(2)
        for shape, S in (((4, 1024, 3), 64), ((2, 777, 3), 130)):
            p = torch.randn(*shape, generator=gen).to(dev)
            kp, rp = ops.furthest_point_sample(p, S), ops.furthest_point_sample_ref(p, S)
            n_sw = tie_swaps(kp, rp)
            if bool((kp[:, 0] != 0).any()) or n_sw < 0:
                fail(f"fps_start0 {shape}->{S}: not the start-0 first-argmax walk")
            errs[f"fps_start0 {shape}->{S}"] = float(
                (ops.gather_points(p, kp) - ops.gather_points(p, rp)).abs().max())
            print(f"[check] fps_start0 (act_tpu/ops/fps.py:29 _fps_kernel) {shape}->{S}: "
                  f"starts at 0, equal up to {n_sw} adjacent tie swaps", flush=True)

    # -- 8. the full-width Stage-II model, seeded weights ---------------------
    t0 = time.perf_counter()
    model = build_pretrain_model(cfg.model, seed=0)
    builder.freeze(model, [TOKENIZER])
    builder.cast_frozen_bf16(model, [TOKENIZER])
    model = model.to(dev).eval()
    n_all = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"[model] {PRETRAIN_CONFIG}: {n_all} params ({n_train} trainable, the rest the "
          f"frozen tokenizer), dtype bf16, built in {time.perf_counter() - t0:.2f} s; "
          f"synthetic clouds {tuple(clouds.shape)}", flush=True)

    # -- 9. one eval forward through the kernels and through the plain versions
    ids = {}

    def recording(fn, key):
        def wrapped(lg, seed):
            ids[key] = fn(lg, seed)
            return ids[key]
        return wrapped

    with torch.no_grad():
        with patched(ops, gumbel_argmax=recording(ops.gumbel_argmax, "kernel")):
            loss_k = float(model(clouds, rngs=step_rngs(0, 0, dev)))
        torch.cuda.synchronize()
        _backend.reset_launches()
        with patched(ops, group_points=ops.group_points_ref,
                     graph_feature_idx=ops.graph_feature_idx_ref,
                     gumbel_argmax=recording(ops.gumbel_argmax_ref, "plain")):
            loss_p = float(model(clouds, rngs=step_rngs(0, 0, dev)))
        torch.cuda.synchronize()
    if any(_backend.LAUNCHES.values()):
        fail(f"the plain-version forward launched kernels: {_backend.LAUNCHES}")
    same_ids = torch.equal(ids["kernel"], ids["plain"])
    print(f"[stage2] eval loss through the kernels {loss_k}, through the plain versions "
          f"{loss_p}: |diff| {abs(loss_k - loss_p)} (tolerance {LOSS_ATOL}); tokenizer "
          f"Gumbel ids {tuple(ids['kernel'].shape)} equal {same_ids}", flush=True)
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= LOSS_ATOL and same_ids):
        fail("Stage-II eval forward: kernel path and plain path disagree")

    # -- 10. run_steps: the train steps of the main path ----------------------
    steps = WARM_STEPS + TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _backend.reset_launches()
    run = run_steps(PRETRAIN_CONFIG, steps, seed=0, device=dev)
    launches = dict(_backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[stage2] run_steps losses: {run.losses}", flush=True)
    print(f"[stage2] launches in {steps} steps: {launches}; a step: "
          f"{ {k: v / steps for k, v in launches.items()} }", flush=True)
    if not all(math.isfinite(x) for x in run.losses):
        fail("run_steps: a loss is not finite")
    check_launches("run_steps", launches, STAGE2_PER_STEP, steps)
    before, after = model.state_dict(), run.model.state_dict()
    tok = [k for k in after if k.startswith(TOKENIZER + ".")]
    tok_params = [k for k in tok if "running" not in k and "num_batches" not in k]
    frozen_same = all(torch.equal(after[k], before[k]) for k in tok_params)
    bn_moved = any(not torch.equal(after[k], before[k]) for k in tok if "running" in k)
    student_moved = all(not torch.equal(after[k], before[k]) for k in
                        ("ACT_encoder.blocks.blocks.0.attn.qkv.weight", "ACT_decoder.norm.weight",
                         "proj_head.weight", "ACT_encoder.cls_head.0.weight"))
    print(f"[stage2] tokenizer parameters bit-for-bit unchanged: {frozen_same} "
          f"({len(tok_params)} tensors); tokenizer BN running stats changed: {bn_moved}; "
          f"student parameters changed: {student_moved}", flush=True)
    if not (frozen_same and bn_moved and student_moved):
        fail("run_steps: the frozen tokenizer moved or the student did not")
    med = statistics.median(run.step_ms[WARM_STEPS:])

    def step(i):
        return pretrain_step(run.model, run.optimizer, lambda s: 1e-6, clouds, i,
                             step_rngs(0, i, dev))
    ev = kernel_events(lambda: step(steps), 3)
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3 / 3
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / 3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    dev_txt = (f"device busy {busy:.3f} ms a step ({len(ev) // 3} kernels), idle share "
               f"{1 - busy / med:.3f}" if ev else "device busy not measured")
    print(f"[time] Stage-II step B={bs}: median {med:.3f} ms, min {min(run.step_ms):.3f}, "
          f"max {max(run.step_ms[WARM_STEPS:]):.3f} over {TIMED_STEPS} (after {WARM_STEPS} "
          f"warm-up); {bs / med * 1e3:.1f} clouds/s; {dev_txt}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    print("[time] Stage-II step top kernels (ms a step): "
          + "; ".join(f"{n[:60]} {t:.4f}" for n, t in top), flush=True)
    tk = run.model.dvae_tokenizer
    with torch.no_grad():
        nbr, ctr = ops.group_points(clouds, G, M)
        run.model.train()
        feats = tk.encoder(nbr)
        lg = tk.dgcnn_1(feats, ctr)
        sampled = tk.codebook[ops.gumbel_argmax(lg, seeds[0]).long()]
        taught = teacher_forward(tk, sampled, ctr, step_rngs(0, 0, dev))
        stage_ms = {
            "group_points": device_ms(lambda: ops.group_points(clouds, G, M), 3),
            "tokenizer (train mode, no grad)": device_ms(
                lambda: tk.forward_tokenizer_features(nbr, ctr, rngs=step_rngs(0, 0, dev)), 3),
            "  of which encoder": device_ms(lambda: tk.encoder(nbr), 3),
            "  dgcnn_1": device_ms(lambda: tk.dgcnn_1(feats, ctr), 3),
            "  teacher": device_ms(
                lambda: teacher_forward(tk, sampled, ctr, step_rngs(0, 0, dev)), 3),
            "  dgcnn_2": device_ms(lambda: tk.dgcnn_2(taught, ctr), 3)}
    stage_ms["whole step"] = device_ms(lambda: step(steps + 1), 3)
    print(f"[time] Stage-II step stages (device ms): " + ", ".join(
        f"{k} {v if v is None else round(v, 5)}" for k, v in stage_ms.items()), flush=True)

    # kernel times at the shapes of a step
    with torch.inference_mode():
        rows = {
            "gumbel_argmax": [measure(
                f"({bs * G}, {V}) bf16", lambda: ops.gumbel_argmax(logits, seeds[0]),
                lambda: ops.gumbel_argmax_ref(logits, seeds[0]), None, 50, 3,
                bound_ms(logits.numel() * 2 + bs * G * 4, GUMBEL_OPS * logits.numel()))],
            "fps": [measure(
                f"({bs}, {npts}, 3)->{G}", lambda: ops.furthest_point_sample(clouds, G),
                lambda: ops.furthest_point_sample_ref(clouds, G), None, 50, 3,
                bound_ms(clouds.numel() * 4 + bs * G * 4, 10.0 * bs * (G - 1) * npts))],
            "k_smallest": [measure(
                f"({d.shape[0]}, {d.shape[1]}) k={kk}", lambda d=d, kk=kk: ops.k_smallest(d, kk),
                lambda d=d, kk=kk: ops.k_smallest_ref(d, kk),
                lambda d=d, kk=kk: torch.topk(d, kk, dim=-1, largest=False, sorted=True),
                100, 20, bound_ms(d.numel() * 4 + d.shape[0] * kk * 8, d.numel()), n)
                for d, kk, n in ((d_grp, M, 1), (d_dg, 4, 2))],
            "gather": [measure(
                f"{tuple(p.shape)} by {tuple(i.shape)}, {distinct_rows(i)} rows read",
                lambda p=p, i=i: ops.gather_coords(p, i), lambda p=p, i=i: ops.gather_points(p, i),
                lambda p=p, li=i.long().reshape(bs, -1, 1).expand(-1, -1, 3).contiguous():
                torch.gather(p, 1, li), 200, 200,
                bound_ms(distinct_rows(i) * 12 + i.numel() * 4 + i.numel() * 12))
                for p, i in gathers],
        }
    print_times("Stage-II ", rows)
    return rows, errs, launches


def stage_one(dev, device_ms, kernel_events, measure):
    """Phases 11-14: FPS and k-smallest at the Stage-I shapes and the Chamfer
    kernels against their plain versions, the
    full-width dVAE's train-mode loss and backward through the kernels and
    through the plain versions, ``run_autoencoder_steps``, ``validate``, and
    the kernel times. Returns (timing rows by kernel, errors, launches of the
    run_autoencoder_steps run, launches of the validate run)."""
    import torch
    from act_tpu_torch import ops
    from act_tpu_torch.datasets import synthetic_batch
    from act_tpu_torch.engine.runner_autoencoder import (get_kld_weight, get_temp,
                                                         prepare_model,
                                                         run_autoencoder_steps, validate)
    from act_tpu_torch.engine.serve import load_config
    from act_tpu_torch.engine.train_state import autoencoder_step, step_rngs
    from act_tpu_torch.models.common import gumbel_softmax_from_u
    from act_tpu_torch.models.teacher import teacher_forward
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.ops import chamfer as chamfer_mod
    from act_tpu_torch.ops.fps import _sms, tie_swaps

    cfg = load_config(AUTOENCODER_CONFIG)
    bs, npts = int(cfg.total_bs), int(cfg.dataset.train.others.npoints)
    G, M = int(cfg.model.num_group), int(cfg.model.group_size)
    clip = cfg.get("grad_norm_clip", None)
    temp, kldw = get_temp(cfg, S1_START_ITR), get_kld_weight(cfg, S1_START_ITR)
    clouds = torch.from_numpy(synthetic_batch(0, bs, npts)).to(dev)
    errs = {}

    # -- 11. FPS and k-smallest at the Stage-I shapes (B=64 picks its own
    # cluster size), then the Chamfer kernels against their plain versions --
    with torch.inference_mode():
        kc, rc = ops.furthest_point_sample(clouds, G), ops.furthest_point_sample_ref(clouds, G)
        n_sw = tie_swaps(kc, rc)
        if n_sw < 0 or not torch.equal(kc.sort(-1).values, rc.sort(-1).values):
            fail(f"fps ({bs}, {npts}, 3)->{G}: kernel picks differ beyond tie swaps")
        errs[f"fps {bs}x{npts}->{G}"] = float(
            (ops.gather_points(clouds, kc) - ops.gather_points(clouds, rc)).abs().max())
        print(f"[check] fps ({bs}, {npts}, 3)->{G}: equal up to {n_sw} adjacent tie swaps",
              flush=True)
        centers = ops.gather_points(clouds, rc)
        s1_d = [(ops.square_distance(centers, clouds).reshape(bs * G, npts), M),
                (ops.square_distance(centers, centers).reshape(bs * G, G), 4)]
        for d, kk in s1_d:
            (kv, ki), (rv, ri) = ops.k_smallest(d, kk), ops.k_smallest_ref(d, kk)
            if not (torch.equal(ki, ri) and torch.equal(kv, rv)):
                fail(f"k_smallest {tuple(d.shape)} k={kk}: differs from the plain version")
            errs[f"k_smallest {tuple(d.shape)} k={kk}"] = 0.0
            print(f"[check] k_smallest {tuple(d.shape)} k={kk}: indices equal, values "
                  "bit-equal", flush=True)
        s1_gathers = [(clouds, rc), (clouds, ops.k_smallest_ref(s1_d[0][0], M)[1].reshape(bs, -1))]
        for p, i in s1_gathers:
            if not torch.equal(ops.gather_coords(p, i), ops.gather_points(p, i)):
                fail(f"gather {tuple(p.shape)} by {tuple(i.shape)}: not bit-equal")
            errs[f"gather Stage I {tuple(i.shape)}"] = 0.0
        print("[check] gather: bit-equal at " + ", ".join(
            f"{tuple(p.shape)} by {tuple(i.shape)}" for p, i in s1_gathers), flush=True)
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    with torch.inference_mode():
        gt = ops.group_points(clouds, G, M)[0].reshape(bs * G, M, 3)
        dup = rnd(2, 100, 3)
        rep = rnd(2, 300, 3)  # repeated past one tile of x and of y: equal minima across tiles
        cases = {  # name -> (x, y)
            "recon coarse": ((gt[:, ::4] + 0.01 * rnd(bs * G, M // 4, 3)).contiguous(), gt),
            "recon fine": ((gt + 0.01 * rnd(bs * G, M, 3)).contiguous(), gt),
            "validation": (0.5 * rnd(1, G * M, 3), clouds[:1].contiguous()),
            "whole cloud": (rnd(*WHOLE_CLOUD, 3), rnd(*WHOLE_CLOUD, 3)),
            "ragged": (rnd(3, 777, 3), rnd(3, 1001, 3)),
            "ties": (dup[:, :60].contiguous(), torch.cat([dup, dup], 1)),
            "ties across tiles": (torch.cat([rep[:, :150]] * 4, 1), torch.cat([rep] * 5, 1)),
        }
        saved = {}
        for name, (x, y) in cases.items():
            tag = f"{name} {tuple(x.shape)}x{tuple(y.shape)}"
            k, r = chamfer_mod.nn_pair(x, y), ops.chamfer_ref(x, y)
            km, rm = chamfer_mod.nn_pair_min(x, y), ops.chamfer_min_ref(x, y)
            if not all(torch.equal(a, b) for a, b in zip(k + km, r + rm)):
                fail(f"chamfer {tag}: kernel distances or indices differ from the plain version")
            g1, g2 = rnd(*x.shape[:2]), rnd(*y.shape[:2])
            kb = chamfer_mod.chamfer_bwd(x, y, r[2], r[3], g1, g2)
            group = max(x.shape[1], y.shape[1]) <= chamfer_mod.BWD_GROUP_MAX
            # the group body against the plain version on CPU copies, bit for bit
            rb = ops.chamfer_bwd_ref(*(t.cpu() if group else t for t in (x, y, *r[2:], g1, g2)))
            scale = max(float(t.abs().max()) for t in rb)
            err = max(float((a.to(b.device) - b).abs().max()) for a, b in zip(kb, rb))
            if group and not all(torch.equal(a.cpu(), b) for a, b in zip(kb, rb)):
                fail(f"chamfer_bwd {tag}: not bit-equal to the plain version on the CPU "
                     f"(max |diff| {err})")
            if not err <= BWD_RTOL * scale:
                fail(f"chamfer_bwd {tag}: max |diff| {err} > {BWD_RTOL} x {scale}")
            errs[f"chamfer_nn {tag}"] = errs[f"chamfer_nn_min {tag}"] = 0.0
            errs[f"chamfer_bwd {tag}"] = err
            saved[name] = (x, y, r[2], r[3], g1, g2)
            bwd_txt = ("bit-equal to the plain version on the CPU (tolerance: exact)" if group
                       else f"max |diff| {err} (tolerance {BWD_RTOL} x max |grad| {scale})")
            print(f"[check] chamfer {tag}: chamfer_nn and chamfer_nn_min distances bit-equal, "
                  f"indices equal (tolerance: exact); chamfer_bwd {bwd_txt}", flush=True)

        def bwd_on_card(*args):
            return [t.cpu() for t in chamfer_mod.chamfer_bwd(*(t.to(dev) for t in args))]
        wrong = [n for n in chamfer_mod.BWD_CASES if not chamfer_mod.check_bwd_case(n, bwd_on_card)]
        if wrong:
            fail(f"chamfer_bwd hard cases: {wrong}")
        errs["chamfer_bwd hard cases"] = 0.0
        print(f"[check] chamfer_bwd hard cases ({', '.join(chamfer_mod.BWD_CASES)}): bit-equal "
              "to the plain version on the CPU, signs of zeros included; an index out of range "
              "gives NaN in its own row only", flush=True)

    # -- 12. the full-width dVAE: one train-mode loss and backward through the
    # kernels and one through the plain versions ------------------------------
    t0 = time.perf_counter()
    model = prepare_model(cfg, 0, dev)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    n_all = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"[model] {AUTOENCODER_CONFIG}: {n_all} params ({n_train} trainable, the rest the "
          f"frozen teacher backbone and the folded conv biases), dtype bf16, built in "
          f"{time.perf_counter() - t0:.2f} s; synthetic clouds {tuple(clouds.shape)}; "
          f"temperature {temp}, KLD weight {kldw} (iteration {S1_START_ITR})", flush=True)
    grad_keys = DOWNSTREAM_KEYS + UPSTREAM_KEYS

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        model.train()
        recon, kld = model.get_loss(model(clouds, temp, False, rngs=step_rngs(0, 0, dev)))
        loss = recon + kldw * kld.float()
        loss.backward()
        return loss.item(), {k: model.get_parameter(k).grad.float() for k in grad_keys}
    _backend.reset_launches()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    check_launches("dVAE loss and backward through the kernels", dict(_backend.LAUNCHES),
                   STAGE1_PER_STEP, 1)
    _, again = loss_and_grads()
    spread = {k: float((again[k] - grads_k[k]).norm() / grads_k[k].norm()) for k in grad_keys}
    _backend.reset_launches()
    with patched(ops, group_points=ops.group_points_ref,
                 graph_feature_idx=ops.graph_feature_idx_ref), \
            patched(chamfer_mod, nn_pair=ops.chamfer_ref, nn_pair_min=ops.chamfer_min_ref,
                    chamfer_bwd=ops.chamfer_bwd_ref):
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    if any(_backend.LAUNCHES.values()):
        fail(f"the plain-version dVAE loss launched kernels: {_backend.LAUNCHES}")
    rel = {k: float((grads_k[k] - grads_p[k]).norm() / grads_p[k].norm()) for k in grad_keys}
    limit = {k: GRAD_RTOL if k in DOWNSTREAM_KEYS else max(GRAD_RTOL, SPREAD_FACTOR * spread[k])
             for k in grad_keys}
    print(f"[stage1] train-mode loss through the kernels {loss_k}, through the plain versions "
          f"{loss_p}: |diff| {abs(loss_k - loss_p)} (tolerance {LOSS_ATOL}); gradients, "
          f"relative L2 difference: {rel}; two kernel-path runs differ by {spread}; "
          f"tolerance ({GRAD_RTOL} on the loss's side of the teacher, {SPREAD_FACTOR} x that "
          f"spread upstream of it): {limit}", flush=True)
    bad = [k for k in grad_keys if not rel[k] <= limit[k]]
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= LOSS_ATOL and not bad):
        fail(f"Stage-I loss and backward: kernel path and plain path disagree ({bad})")
    del model, grads_k, grads_p, again

    # -- 13. run_autoencoder_steps: the train steps of the main path ----------
    steps = S1_WARM_STEPS + S1_TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _backend.reset_launches()
    run = run_autoencoder_steps(AUTOENCODER_CONFIG, steps, seed=0, start_itr=S1_START_ITR,
                                device=dev)
    launches = dict(_backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[stage1] run_autoencoder_steps losses: {run.losses}; recon {run.recon}; kld "
          f"{run.kld}; temperature {run.temps[0]:.5f}, KLD weight {run.kld_weights[0]:.5f}",
          flush=True)
    print(f"[stage1] launches in {steps} steps: {launches}; a step: "
          f"{ {k: v / steps for k, v in launches.items()} }", flush=True)
    if not all(math.isfinite(x) for x in run.losses + run.recon + run.kld):
        fail("run_autoencoder_steps: a loss is not finite")
    check_launches("run_autoencoder_steps", launches, STAGE1_PER_STEP, steps)
    after = {k: v.detach().cpu() for k, v in run.model.state_dict().items()}
    frozen = [k for k in after if k.startswith("visual_embed.")]
    frozen_same = all(torch.equal(after[k], init[k]) for k in frozen)
    moved_keys = ("visual_prompt_token", "deep_prompt_tokens", "decoder.final_conv.6.weight",
                  "encoder.first_conv.0.weight", "encoder.first_conv.1.running_mean",
                  "decoder.final_conv.4.running_var")
    moved = {k: not torch.equal(after[k], init[k]) for k in moved_keys}
    print(f"[stage1] teacher blocks and final norm bit-for-bit unchanged: {frozen_same} "
          f"({len(frozen)} tensors); moved: {moved}", flush=True)
    if not (frozen_same and all(moved.values())):
        fail("run_autoencoder_steps: the frozen teacher moved or a trained tensor did not")
    med = statistics.median(run.step_ms[S1_WARM_STEPS:])

    def step(i):
        return autoencoder_step(run.model, run.optimizer, lambda s: 1e-6, clouds, i,
                                step_rngs(0, i, dev), temp, kldw, clip)
    ev = kernel_events(lambda: step(steps), 3)
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3 / 3
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / 3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    dev_txt = (f"device busy {busy:.3f} ms a step ({len(ev) // 3} kernels), idle share "
               f"{1 - busy / med:.3f}" if ev else "device busy not measured")
    print(f"[time] Stage-I step B={bs}: median {med:.3f} ms, min {min(run.step_ms):.3f}, "
          f"max {max(run.step_ms[S1_WARM_STEPS:]):.3f} over {S1_TIMED_STEPS} (after "
          f"{S1_WARM_STEPS} warm-up); {bs / med * 1e3:.1f} clouds/s; {dev_txt}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    print("[time] Stage-I step top kernels (ms a step): "
          + "; ".join(f"{n[:60]} {t:.4f}" for n, t in top), flush=True)

    # device ms of the stages, each forward and backward in training mode
    m = run.model.train()
    rngs = step_rngs(0, 0, dev)

    def fwd_bwd(fn, *xs):
        """fn's forward and backward: into its parameters and the inputs xs."""
        def call():
            out = fn(*[x.detach().requires_grad_() for x in xs])
            outs = out if isinstance(out, tuple) else (out,)
            torch.autograd.backward([o for o in outs if o.requires_grad],
                                    [torch.ones_like(o) for o in outs if o.requires_grad])
        return call
    with torch.no_grad():
        nbr, ctr = ops.group_points(clouds, G, M)
        feats = m.encoder(nbr)
        lg = m.dgcnn_1(feats, ctr)
        u = torch.rand(lg.shape, generator=g, device=dev).clamp_min(1e-10)
        sampled = torch.matmul(gumbel_softmax_from_u(u, lg, temp), m.codebook)
        taught = teacher_forward(m, sampled, ctr, rngs)
        feat2 = m.dgcnn_2(taught, ctr)
        coarse, fine = m.decoder(feat2)
    stage_ms = {
        "group_points": device_ms(lambda: ops.group_points(clouds, G, M), 3),
        "encoder": device_ms(fwd_bwd(lambda: m.encoder(nbr)), 3),
        "dgcnn_1": device_ms(fwd_bwd(lambda f: m.dgcnn_1(f, ctr), feats), 3),
        "soft Gumbel + codebook product": device_ms(fwd_bwd(
            lambda x: torch.matmul(gumbel_softmax_from_u(u, x, temp), m.codebook), lg), 3),
        "teacher": device_ms(fwd_bwd(lambda x: teacher_forward(m, x, ctr, rngs), sampled), 3),
        "dgcnn_2": device_ms(fwd_bwd(lambda f: m.dgcnn_2(f, ctr), taught), 3),
        "decoder": device_ms(fwd_bwd(m.decoder, feat2), 3),
        "two Chamfer losses": device_ms(fwd_bwd(
            lambda c, f: m.recon_loss((None, None, c, f, nbr, None)), coarse, fine), 3),
        "whole step": device_ms(lambda: step(steps + 1), 3)}
    print("[time] Stage-I step stages, forward + backward (device ms): " + ", ".join(
        f"{k} {v if v is None else round(v, 5)}" for k, v in stage_ms.items()), flush=True)

    # -- 14. validate: the reconstruction metrics -----------------------------
    val = [torch.from_numpy(c) for c in synthetic_batch(1, VAL_CLOUDS, npts)]
    _backend.reset_launches()
    metrics, per_cloud = validate(run.model, val)
    val_launches = dict(_backend.LAUNCHES)
    check_launches("validate", val_launches, VALIDATE_PER_CLOUD, VAL_CLOUDS)
    _backend.reset_launches()
    with patched(ops, group_points=ops.group_points_ref,
                 graph_feature_idx=ops.graph_feature_idx_ref), \
            patched(chamfer_mod, nn_pair_min=ops.chamfer_min_ref):
        metrics_p, per_cloud_p = validate(run.model, val)
    if any(_backend.LAUNCHES.values()):
        fail(f"the plain-version validate launched kernels: {_backend.LAUNCHES}")
    worst = max(abs(a - b) / max(abs(b), 1e-12) for ra, rb in zip(per_cloud, per_cloud_p)
                for a, b in zip(ra, rb))
    print(f"[stage1] validate on {VAL_CLOUDS} clouds: {metrics.state_dict()} through the "
          f"kernels, {metrics_p.state_dict()} through the plain versions; worst relative "
          f"difference of a cloud's metric {worst} (tolerance {METRIC_RTOL}); launches "
          f"{val_launches}", flush=True)
    if not (all(math.isfinite(x) for row in per_cloud for x in row) and worst <= METRIC_RTOL):
        fail("validate: metrics not finite or kernel path and plain path disagree")

    # kernel times at the shapes of a step (recon loss) and of a validation cloud
    with torch.inference_mode():
        pairs = [(saved[n], 1) for n in ("recon coarse", "recon fine")]
        rows = {
            "chamfer_nn": [measure(
                f"{tuple(x.shape)}x{tuple(y.shape)}", lambda x=x, y=y: chamfer_mod.nn_pair(x, y),
                lambda x=x, y=y: ops.chamfer_ref(x, y), None, 100, 10,
                chamfer_bounds(x, y, True), n) for (x, y, *_), n in pairs],
            "chamfer_bwd": [measure(
                f"{tuple(a[0].shape)}x{tuple(a[1].shape)}",
                lambda a=a: chamfer_mod.chamfer_bwd(*a), lambda a=a: ops.chamfer_bwd_ref(*a),
                None, 100, 10, chamfer_bwd_bounds(a[0], a[1]), n) for a, n in pairs],
            "chamfer_nn_min": [measure(
                f"{tuple(x.shape)}x{tuple(y.shape)}",
                lambda x=x, y=y: chamfer_mod.nn_pair_min(x, y),
                lambda x=x, y=y: ops.chamfer_min_ref(x, y), None, 100, 5,
                chamfer_bounds(x, y, False), n)
                for (x, y, *_), n in ((saved["validation"], 1), (saved["whole cloud"], 0))],
            "fps": [measure(
                f"({bs}, {npts}, 3)->{G}", lambda: ops.furthest_point_sample(clouds, G),
                lambda: ops.furthest_point_sample_ref(clouds, G), None, 50, 3,
                bound_ms(clouds.numel() * 4 + bs * G * 4, 10.0 * bs * (G - 1) * npts))],
            "k_smallest": [measure(
                f"({d.shape[0]}, {d.shape[1]}) k={kk}", lambda d=d, kk=kk: ops.k_smallest(d, kk),
                lambda d=d, kk=kk: ops.k_smallest_ref(d, kk),
                lambda d=d, kk=kk: torch.topk(d, kk, dim=-1, largest=False, sorted=True),
                100, 20, bound_ms(d.numel() * 4 + d.shape[0] * kk * 8, d.numel()), n)
                for (d, kk), n in zip(s1_d, (1, 2))],
            "gather": [measure(
                f"{tuple(p.shape)} by {tuple(i.shape)}, {distinct_rows(i)} rows read",
                lambda p=p, i=i: ops.gather_coords(p, i), lambda p=p, i=i: ops.gather_points(p, i),
                lambda p=p, li=i.long().reshape(bs, -1, 1).expand(-1, -1, 3).contiguous():
                torch.gather(p, 1, li), 200, 200,
                bound_ms(distinct_rows(i) * 12 + i.numel() * 4 + i.numel() * 12))
                for p, i in s1_gathers],
        }
    print_times("Stage-I ", rows)
    sms = _sms(torch.cuda.current_device())
    for name, names in (("chamfer_nn", ("recon coarse", "recon fine")),
                        ("chamfer_nn_min", ("validation", "whole cloud"))):
        for x, y, *_ in (saved[n] for n in names):
            print(f"[geometry] {name} {tuple(x.shape)}x{tuple(y.shape)}: (tq, tt, r, threads, "
                  f"pack) = {chamfer_mod.launch_geometry(x.shape[0], x.shape[1], y.shape[1], sms)}",
                  flush=True)
    # one validation cloud on the path that chamfer_nn_min serves
    cloud_ms = device_ms(lambda: validate(run.model, val[:1]), 5)
    nn_min_ms = rows["chamfer_nn_min"][0]["ms"]
    share = "not measured" if cloud_ms is None else f"{nn_min_ms / cloud_ms:.4f}"
    print(f"[time] validate per cloud: device "
          f"{'not measured' if cloud_ms is None else f'{cloud_ms:.5f}'} ms (the forward and "
          f"the metrics of one cloud of {npts} points); chamfer_nn_min {nn_min_ms:.5f} ms of it, "
          f"share {share}", flush=True)
    return rows, errs, launches, val_launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from act_tpu_torch import ops
        from act_tpu_torch.engine.serve import build_infer_fn, load_config, load_model
        from act_tpu_torch.ops import _backend
        from act_tpu_torch.ops import gather as gather_mod
        from act_tpu_torch.ops.fps import tie_swaps
        from act_tpu_torch.profiling import device_ms, kernel_events
        from act_tpu_torch.serve_http import make_server
    except ImportError as e:
        fail(f"the act_tpu_torch package is not beside this script ({e})")
    os.chdir(ROOT)  # the configs' _base_ paths are relative to the repo root
    dev = _backend.resolve_device("cuda")
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # -- 1. build -----------------------------------------------------------
    if sorted(REPLACES) != sorted(_backend.KERNELS):
        fail(f"REPLACES names {sorted(REPLACES)}, the package builds {sorted(_backend.KERNELS)}")
    t0 = time.perf_counter()
    _backend.build_kernels()
    print(f"[build] {len(_backend.KERNELS)} kernels ({', '.join(_backend.KERNELS)}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
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
        k_one = ops.furthest_point_sample(clouds[:1], npoints)  # the B=1 request
        r_one = ops.furthest_point_sample_ref(clouds[:1], npoints)
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
    for tag, k, r, p in (("8192->1024", k_rs, r_rs, clouds), ("1024->64", k_c, r_c, pts),
                         ("B=1 8192->1024", k_one, r_one, clouds[:1])):
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
    wrong = gather_mod.check_gather_cases(ops.gather_coords, dev)
    if wrong:
        fail(f"gather hard cases: {wrong}")
    print("[check] gather hard cases (C = 1-8 through both bodies, S a multiple of 4 and not, "
          "an index view at an odd offset, B = 0, S = 0): bit-equal; an index out of range "
          "gathers NaN", flush=True)

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
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the serving path")
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
    # printed beside it as "per call". A window whose records are not all
    # there gives no device time (act_tpu_torch/profiling.py); the row then
    # keeps the CUDA-event time and says so.
    print(f"[time] card: {card}", flush=True)

    def measure(shape, fn, plain, library, iters, plain_iters, bound, n=1):
        """Times of one launch shape; ``n`` launches of it a step or request."""
        call = timed(fn, iters)
        dev_ms = device_ms(fn, iters)
        return dict(shape=shape, n=n, ms=call if dev_ms is None else dev_ms, call_ms=call,
                    timing="cuda_events" if dev_ms is None else "profiler",
                    plain_ms=device_ms(plain, plain_iters) or timed(plain, plain_iters, 1),
                    library_ms=None if library is None else
                    (device_ms(library, iters) or timed(library, iters)),
                    bound=bound)

    with torch.inference_mode():
        d_pts = pts.contiguous()
        one = clouds[:1].contiguous()
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
                measure(f"(1, {N_IN}, 3)->{npoints} (B=1 request)",
                        lambda: ops.furthest_point_sample(one, npoints),
                        lambda: ops.furthest_point_sample_ref(one, npoints), None, 20, 1,
                        bound_ms(one.numel() * 4 + npoints * 4,
                                 10.0 * (npoints - 1) * N_IN)),
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
    print_times("", shapes)

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
        stage["resample at B=1"] = lambda: ops.gather_coords(
            one, ops.furthest_point_sample(one, npoints))
        stage["group_points"] = lambda: ops.group_points(d_pts, G, M)
        nbr, ctr = ops.group_points(d_pts, G, M)
        stage["model after grouping"] = lambda: model.forward_grouped(nbr, ctr)
        stage_ms = {k: (device_ms(fn, 5), timed(fn, 10)) for k, fn in stage.items()}
    print(f"[time] B={B} stages (device ms, per-call ms): " + ", ".join(
        f"{k} {dv if dv is None else round(dv, 5)}, {c:.5f}" for k, (dv, c) in stage_ms.items()),
        flush=True)

    # -- 6-10. Stage-II pretraining ----------------------------------------------
    stage2, s2_errs, s2_launches = stage_two(dev, device_ms, kernel_events, measure)
    errs.update(s2_errs)
    # -- 11-14. Stage-I autoencoder training and its metrics ------------------------
    stage1, s1_errs, s1_launches, val_launches = stage_one(dev, device_ms, kernel_events,
                                                           measure)
    errs.update(s1_errs)
    # kernel -> (its path, the path's timing rows, the launches of its run)
    paths = {k: ("pretrain", stage2, s2_launches) for k in STAGE2_PER_STEP}
    paths.update({k: ("autoencoder", stage1, s1_launches) for k in ("chamfer_nn", "chamfer_bwd")})
    paths["chamfer_nn_min"] = ("validate (a unit is one cloud)", stage1, val_launches)

    def row_entry(name, kernel, replaces):
        """One kernel's record: launches of its path's run, times summed over
        the launches of one step (or validation cloud) of that path; the
        serving launches listed beside them."""
        path, by_kernel, path_launches = paths[kernel]
        rows = by_kernel[kernel]
        per_step = sum(r["n"] for r in rows)
        return {
            "name": name, "route": "cuda",
            "source": f"act_tpu_torch/csrc/{_backend.KERNELS[kernel][0]}.cu",
            "replaces": replaces, "path": path, "launches": path_launches[kernel],
            "launches_per_step": per_step, "launches_serve_b32": launches[kernel],
            "max_abs_err": max(v for k, v in errs.items() if k.split()[0] == name),
            "ms": sum(r["ms"] * r["n"] for r in rows),
            "plain_ms": sum(r["plain_ms"] * r["n"] for r in rows),
            "bound_ms": sum(r["bound"][0] * r["n"] for r in rows),
            "bound_by": rows[0]["bound"][1],
            "library_ms": (None if rows[0]["library_ms"] is None
                           else sum(r["library_ms"] * r["n"] for r in rows)),
            "timing": rows[0]["timing"],
            "per_launch": [{"path": where, "shape": r["shape"], "per_step_or_request": r["n"],
                            "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
                            "bound_ms": r["bound"][0], "library_ms": r["library_ms"]}
                           for where, group in ((path, rows), ("serve", shapes.get(kernel, [])),
                                                ("autoencoder", [] if by_kernel is stage1
                                                 else stage1.get(kernel, [])))
                           for r in group],
        }

    record = [row_entry(name, name, REPLACES[name]) for name in REPLACES]
    record += [row_entry(name, kernel, rep) for name, (kernel, rep) in COVERED.items()]
    print(json.dumps({"kernels": record}, allow_nan=False), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
