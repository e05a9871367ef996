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
- classification finetune: ``PointTransformer`` at ``finetune_modelnet.yaml``
  (B=32 synthetic ModelNet clouds of 8192 points resampled by FPS to 1200
  and a random 1024 of those, rotated, drop path 0.1, the mlp-3 head's
  dropout, AdamW with CosLR, clip 10, bf16, seeded weights): the kernels at
  the finetune shapes, one train-mode loss and backward through the kernels
  and one through the plain versions, ``run_finetune_steps`` for a few
  train steps, ``validate`` at B=64 and the vote (``validate_vote``,
  ``test_vote_rounds``), the kernel path's validation logits and summed vote
  probabilities bit-equal to the plain path's;
- the user's pipeline through the trainers' entry points: Stage I
  (``runner_autoencoder.run_net`` through the ShapeNet-55 loader, the
  per-taxonomy validation, ckpt-best and ckpt-last, a resume, ``test_net``
  with its dumps), then Stage II (``runner_pretrain.run_net`` with the
  Stage-I ckpt-best as its frozen tokenizer, bit-equal in bf16 before and
  after the steps, the SVM probe, its checkpoints), the probe's features
  through the kernels against the plain path, one finetune step from the
  Stage-II checkpoint, and the loader's clouds/s; checkpoints and data under
  a temporary directory, deleted afterwards;

and times the kernels (the probe's and the Stage-I validation's launch shapes
too), their plain versions, the matching library calls, the requests and the
train steps.

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
FT_WARM_STEPS, FT_TIMED_STEPS = 3, 10  # finetune steps (phase 17)
FT_VAL_CLOUDS = 128  # test clouds of the finetune validation (phase 18)
FT_VOTE_ROUNDS = 2
# full-width finetune gradients, kernel path against plain path (phase 16):
# phase 12's rule, SPREAD_FACTOR times the spread of two kernel-path runs
# (bf16 products; cuBLAS and the attention's reductions need not repeat bit
# for bit), never below GRAD_RTOL
FT_GRAD_KEYS = ("cls_head_finetune.8.weight", "cls_head_finetune.0.weight",
                "blocks.blocks.{last}.mlp.fc2.weight", "blocks.blocks.0.attn.qkv.weight",
                "cls_pos", "pos_embed.0.weight", "encoder.first_conv.0.weight")
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
# a finetune train step (and a vote): the resample's FPS, the index compose and
# the cloud gather, then group_points' FPS, k-smallest and two gathers
FINETUNE_PER_STEP = {"fps": 2, "k_smallest": 1, "gather": 4}
FT_VALIDATE_PER_BATCH = {"fps": 2, "k_smallest": 1, "gather": 3}  # no index compose
# the Stage-I -> Stage-II -> finetune chain (phases 19-24): the SVM probe's
# batch (2 x total_bs of pretrain_act_distill.yaml) and its launches a batch
# (the FPS resample and its gather, then group_points), the capped runs
PROBE_BATCH, PROBE_CLASSES = 256, 40
PROBE_PER_BATCH = {"fps": 2, "k_smallest": 1, "gather": 3}
RECON_PER_CLOUD = {"fps": 1, "k_smallest": 3, "gather": 2}  # a dumped reconstruction
S1_RUN_STEPS, S1_RUN_VAL, S1_RESUME_VAL, S1_TEST_CLOUDS = 4, 16, 4, 4
S2_RUN_STEPS = 3
LOADER_CLOUDS, LOADER_BATCH, LOADER_WORKERS = 256, 32, 8  # the .npy tree of phase 24
# probe features through the kernels against the plain path (phase 22): equal
# bit for bit when no FPS launch of the batch swapped a tie (the same inputs
# through the same bf16 products); a swap reorders the groups, and bf16 sums
# in another order stay within FEAT_ATOL
FEAT_ATOL = 0.05
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
    cloud_ms = device_ms(lambda: validate(run.model, val[:1], logger="silent"), 5)
    nn_min_ms = rows["chamfer_nn_min"][0]["ms"]
    share = "not measured" if cloud_ms is None else f"{nn_min_ms / cloud_ms:.4f}"
    print(f"[time] validate per cloud: device "
          f"{'not measured' if cloud_ms is None else f'{cloud_ms:.5f}'} ms (the forward and "
          f"the metrics of one cloud of {npts} points); chamfer_nn_min {nn_min_ms:.5f} ms of it, "
          f"share {share}", flush=True)
    return rows, errs, launches, val_launches


def finetune(dev, device_ms, kernel_events, measure):
    """Phases 15-18: the kernels at the finetune shapes against their plain
    versions, the full-width classifier's train-mode loss and backward
    through the kernels and through the plain versions,
    ``run_finetune_steps``, ``validate`` and the vote, and the kernel times.
    Returns (timing rows by kernel, errors, launches of the
    run_finetune_steps run)."""
    import itertools
    import torch
    from act_tpu_torch import ops
    from act_tpu_torch.engine import serve
    from act_tpu_torch.datasets.transforms import scale_and_translate
    from act_tpu_torch.engine.runner_finetune import (VOTE_TIMES, _point_all, build_state,
                                                      finetune_config, loaders, predict,
                                                      run_finetune_steps, test_vote_rounds,
                                                      train_transform, validate_vote,
                                                      vote_generator, vote_logits)
    from act_tpu_torch.engine.train_state import step_rngs
    from act_tpu_torch.models.point_transformer import get_loss_acc
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.engine.train_state import finetune_step
    from act_tpu_torch.ops import fps as fps_mod
    from act_tpu_torch.ops.fps import tie_swaps
    from act_tpu_torch.ops.group import subset_draw
    from act_tpu_torch.utils.meters import balanced_accuracy

    cfg = finetune_config(CONFIG)
    npoints, G, M = int(cfg.npoints), int(cfg.model.num_group), int(cfg.model.group_size)
    n_fps = _point_all(npoints)
    train_loader, val_loader = loaders(cfg, 0)
    bs, vbs = train_loader.batch_size, val_loader.batch_size
    _, _, (pts_np, labels_np) = next(iter(train_loader))
    clouds = torch.from_numpy(pts_np).to(dev)
    labels = torch.from_numpy(labels_np).to(dev)
    val = list(itertools.islice(val_loader, FT_VAL_CLOUDS // vbs))
    vclouds = torch.from_numpy(val[0][2][0]).to(dev)
    errs = {}

    def fps_subsample_plain(xyz, nf, n_out, gen):
        """``ops.fps_subsample`` through the plain versions: the same draws,
        the picks composed by an integer torch.gather."""
        sub = subset_draw(xyz.shape[0], min(nf, xyz.shape[1]), n_out, gen, xyz.device)
        if nf >= xyz.shape[1]:
            return ops.gather_points(xyz, sub)
        picks = ops.furthest_point_sample_ref(xyz, nf)
        return ops.gather_points(xyz, torch.gather(picks, 1, sub.long()))

    def check_fps(p, S, tag, say=True):
        k, r = ops.furthest_point_sample(p, S), ops.furthest_point_sample_ref(p, S)
        n_sw = tie_swaps(k, r)
        if n_sw < 0 or not torch.equal(k.sort(-1).values, r.sort(-1).values):
            fail(f"fps {tag} {tuple(p.shape)}->{S}: kernel picks differ beyond tie swaps")
        errs[f"fps finetune {tag} {tuple(p.shape)}->{S}"] = float(
            (ops.gather_points(p, k) - ops.gather_points(p, r)).abs().max())
        c = fps_mod.launch_geometry(p.shape[0], p.shape[1], fps_mod._sms(dev.index or 0),
                                    fps_mod._max_clusters)
        if say:
            print(f"[check] fps {tag} {tuple(p.shape)}->{S}: equal up to {n_sw} adjacent tie "
                  f"swaps (same set); geometry (cluster, threads, points a thread) = {c}",
                  flush=True)
        return r, n_sw

    def check_compose(picks, sub, tag):
        """The index compose of ``fps_subsample`` through the gather kernel,
        bit-equal to an integer torch.gather; returns the composed picks."""
        out = ops.gather_coords(picks.view(torch.float32)[:, :, None], sub)
        final = out[:, :, 0].view(torch.int32).contiguous()
        if not torch.equal(final, torch.gather(picks, 1, sub.long())):
            fail(f"fps_subsample {tag} index compose: not bit-equal to an integer torch.gather")
        errs[f"gather finetune {tag} index compose"] = 0.0
        return final

    def hold_equal(tag, k, p, swaps):
        """The kernel path's outputs ``k`` (a row a cloud) against the plain
        path's ``p``: bit-equal, or within LOGIT_ATOL where an FPS tie swap
        was counted on the way. Each cloud's row must differ from the next
        cloud's, so that the comparison sees what the kernels fed the model."""
        k, p = torch.as_tensor(k).float().cpu(), torch.as_tensor(p).float().cpu()
        diff = float((k - p).abs().max())
        apart = (k[1:] - k[:-1]).abs().amax(-1)
        print(f"[check] {tag} {tuple(k.shape)}: kernel path against plain path max |diff| "
              f"{diff} (tolerance: bit-equal, or {LOGIT_ATOL} with FPS tie swaps; "
              f"{swaps} counted); neighbouring clouds' rows differ by {float(apart.min())} "
              f"to {float(apart.max())}", flush=True)
        if not float(apart.min()) > 0:
            fail(f"{tag}: two clouds give the same row, the comparison cannot see the kernels")
        if not (torch.equal(k, p) or (swaps and diff <= LOGIT_ATOL)):
            fail(f"{tag}: kernel path and plain path disagree")

    # -- 15. the finetune kernels at their shapes against their plain versions
    with torch.inference_mode():
        picks, sw_train = check_fps(clouds, n_fps, "train resample")
        sub = subset_draw(bs, n_fps, npoints, torch.Generator(device=dev).manual_seed(9), dev)
        final = check_compose(picks, sub, "train")
        resampled = ops.gather_coords(clouds, final)
        whole = ops.fps_subsample_by(clouds, n_fps, sub)
        if sw_train == 0 and not torch.equal(whole, resampled):
            fail("fps_subsample: not the kernels' compose and gather")
        vres, _ = check_fps(vclouds, npoints, "validation resample")
        vpicks, _ = check_fps(vclouds, n_fps, "vote resample")
        vsub = subset_draw(vbs, n_fps, npoints, torch.Generator(device=dev).manual_seed(10), dev)
        vfinal = check_compose(vpicks, vsub, "vote")
        print(f"[check] fps_subsample ({bs}, {N_IN}, 3)->{n_fps}->{npoints} and ({vbs}, {N_IN}, "
              f"3)->{n_fps}->{npoints} (the vote): index compose, int32 bits as f32, "
              f"bit-equal to an integer torch.gather (tolerance: exact)", flush=True)
        vpts = ops.gather_points(vclouds, vres)
        vc, _ = check_fps(vpts, G, "validation groups")
        vd = ops.square_distance(ops.gather_points(vpts, vc), vpts).reshape(vbs * G, npoints)
        (kv, ki), (rv, ri) = ops.k_smallest(vd, M), ops.k_smallest_ref(vd, M)
        if not (torch.equal(ki, ri) and torch.equal(kv, rv)):
            fail(f"k_smallest {tuple(vd.shape)} k={M}: differs from the plain version")
        errs[f"k_smallest finetune {tuple(vd.shape)}"] = 0.0
        print(f"[check] k_smallest {tuple(vd.shape)} k={M}: indices equal, values bit-equal",
              flush=True)
        tpts = resampled.contiguous()
        tc = ops.furthest_point_sample_ref(tpts, G)
        td = ops.square_distance(ops.gather_points(tpts, tc), tpts).reshape(bs * G, npoints)
        t_nbr = ops.k_smallest_ref(td, M)[1].reshape(bs, G * M)
        # (points, index, tag, launches a train step): a step's four, then a
        # validation batch's three and a vote's two
        ft_gathers = [(picks.view(torch.float32)[:, :, None], sub, "index compose", 1),
                      (clouds, final, "resample", 1), (tpts, tc, "centers", 1),
                      (tpts, t_nbr, "neighbourhoods", 1),
                      (vclouds, vres, "validation resample", 0),
                      (vpts, vc, "validation centers", 0),
                      (vpts, ri.reshape(vbs, G * M), "validation neighbourhoods", 0),
                      (vpicks.view(torch.float32)[:, :, None], vsub, "vote index compose", 0),
                      (vclouds, vfinal, "vote resample", 0)]
        for p, i, tag, _ in ft_gathers:
            if not torch.equal(ops.gather_coords(p, i).view(torch.int32),
                               ops.gather_points(p, i).view(torch.int32)):
                fail(f"gather {tag} {tuple(p.shape)} by {tuple(i.shape)}: not bit-equal")
            errs[f"gather finetune {tag}"] = 0.0
        print("[check] gather: bit-equal (compared as int32 bits) at " + ", ".join(
            f"{tag} {tuple(p.shape)} by {tuple(i.shape)}" for p, i, tag, _ in ft_gathers),
            flush=True)

    # kernel times at the shapes of a finetune step, a validation batch and a vote
    with torch.inference_mode():
        fps_rows = []
        for p, S, n in ((clouds, n_fps, 1), (tpts, G, 1), (vclouds, npoints, 0),
                        (vclouds, n_fps, 0)):
            B_, N_ = p.shape[:2]
            fps_rows.append(measure(
                f"({B_}, {N_}, 3)->{S}", lambda p=p, S=S: ops.furthest_point_sample(p, S),
                lambda p=p, S=S: ops.furthest_point_sample_ref(p, S), None, 20, 1,
                bound_ms(p.numel() * 4 + B_ * S * 4, 10.0 * B_ * (S - 1) * N_), n))
        rows = {
            "fps": fps_rows,
            "k_smallest": [measure(
                f"({d.shape[0]}, {d.shape[1]}) k={M}", lambda d=d: ops.k_smallest(d, M),
                lambda d=d: ops.k_smallest_ref(d, M),
                lambda d=d: torch.topk(d, M, dim=-1, largest=False, sorted=True),
                100, 20, bound_ms(d.numel() * 4 + d.shape[0] * M * 8, d.numel()), n)
                for d, n in ((td, 1), (vd, 0))],
            "gather": [measure(
                f"{tag} {tuple(p.shape)} by {tuple(i.shape)}, {distinct_rows(i)} rows read",
                lambda p=p, i=i: ops.gather_coords(p, i), lambda p=p, i=i: ops.gather_points(p, i),
                lambda p=p, li=i.long().reshape(p.shape[0], -1, 1).expand(
                    -1, -1, p.shape[-1]).contiguous(): torch.gather(p, 1, li), 200, 200,
                bound_ms(distinct_rows(i) * p.shape[-1] * 4 + i.numel() * 4
                         + i.numel() * p.shape[-1] * 4), n)
                for p, i, tag, n in ft_gathers],
        }
    print_times("finetune ", rows)

    # -- 16. one full-width loss and backward through the kernels and through
    # the plain versions, the same pinned draws and batch -----------------------
    if sw_train:
        fail(f"fps train resample: {sw_train} tie swaps change the kept points; "
             "phase 16 needs a batch without them")
    t0 = time.perf_counter()
    st = build_state(cfg, len(train_loader), seed=0, device=dev)
    model = st.model
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    n_all = sum(p.numel() for p in model.parameters())
    print(f"[model] finetune {CONFIG}: {n_all} params, dtype bf16, drop path "
          f"{cfg.model.drop_path_rate}, built in {time.perf_counter() - t0:.2f} s; "
          f"synthetic ModelNet clouds {tuple(clouds.shape)}", flush=True)
    transform = train_transform(npoints)
    grad_keys = [k.format(last=int(cfg.model.depth) - 1) for k in FT_GRAD_KEYS]

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        model.train()
        rngs = step_rngs(0, 0, dev)
        loss = get_loss_acc(model(transform(clouds, rngs["augment"]), rngs=rngs), labels)[0]
        loss.backward()
        return loss.item(), {k: model.get_parameter(k).grad.float() for k in grad_keys}
    with torch.no_grad():  # the grouping of the transformed batch: no tie swap there either
        moved = transform(clouds, step_rngs(0, 0, dev)["augment"])
        check_fps(moved.contiguous(), G, "train groups")
    _backend.reset_launches()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    check_launches("finetune loss and backward through the kernels", dict(_backend.LAUNCHES),
                   FINETUNE_PER_STEP, 1)
    _, again = loss_and_grads()
    spread = {k: float((again[k] - grads_k[k]).norm() / grads_k[k].norm()) for k in grad_keys}
    _backend.reset_launches()
    with patched(ops, fps_subsample=fps_subsample_plain, group_points=ops.group_points_ref):
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    if any(_backend.LAUNCHES.values()):
        fail(f"the plain-version finetune loss launched kernels: {_backend.LAUNCHES}")
    rel = {k: float((grads_k[k] - grads_p[k]).norm() / grads_p[k].norm()) for k in grad_keys}
    limit = {k: max(GRAD_RTOL, SPREAD_FACTOR * spread[k]) for k in grad_keys}
    print(f"[finetune] train-mode loss through the kernels {loss_k}, through the plain "
          f"versions {loss_p}: |diff| {abs(loss_k - loss_p)} (tolerance {LOSS_ATOL}); "
          f"gradients, relative L2 difference: {rel}; two kernel-path runs differ by "
          f"{spread}; tolerance ({SPREAD_FACTOR} x that spread, at least {GRAD_RTOL}): "
          f"{limit}", flush=True)
    bad = [k for k in grad_keys if not rel[k] <= limit[k]]
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= LOSS_ATOL and not bad):
        fail(f"finetune loss and backward: kernel path and plain path disagree ({bad})")
    model.zero_grad(set_to_none=True)
    model.load_state_dict({k: v.to(dev) for k, v in init.items()})

    # -- 17. run_finetune_steps: the train steps of the main path --------------
    steps = FT_WARM_STEPS + FT_TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _backend.reset_launches()
    run = run_finetune_steps(CONFIG, steps, seed=0, device=dev, state=st)
    launches = dict(_backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[finetune] run_finetune_steps losses: {run.losses}; accuracies {run.accs}",
          flush=True)
    print(f"[finetune] launches in {steps} steps: {launches}; a step: "
          f"{ {k: v / steps for k, v in launches.items()} }", flush=True)
    if not all(math.isfinite(x) for x in run.losses):
        fail("run_finetune_steps: a loss is not finite")
    check_launches("run_finetune_steps", launches, FINETUNE_PER_STEP, steps)
    after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    trained = [n for n, p in model.named_parameters() if p.requires_grad]
    still = [n for n in trained if torch.equal(after[n], init[n])]
    running = [k for k in after if "running" in k]
    bn_still = [k for k in running if torch.equal(after[k], init[k])]
    print(f"[finetune] trainable tensors moved: {len(trained) - len(still)} of {len(trained)}; "
          f"BN running statistics moved: {len(running) - len(bn_still)} of {len(running)}",
          flush=True)
    if still or bn_still:
        fail(f"run_finetune_steps: tensors did not move: {still + bn_still}")
    med = statistics.median(run.step_ms[FT_WARM_STEPS:])
    opt, schedule = st.optimizer, st.schedule

    def step(i):
        return finetune_step(model, opt, lambda s: 1e-6, clouds, labels, i,
                             step_rngs(0, i, dev), transform, st.grad_norm_clip)
    ev = kernel_events(lambda: step(steps), 3)
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / 3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    gen = torch.Generator(device=dev).manual_seed(1)
    rngs = step_rngs(0, 0, dev)
    with torch.no_grad():
        tpts = transform(clouds, gen).contiguous()
        nbr, ctr = ops.group_points(tpts, G, M)

    def fwd_bwd():
        model.train()
        get_loss_acc(model.forward_grouped(nbr, ctr, rngs), labels)[0].backward()
    fwd_bwd()
    parts = {"resample (fps_subsample + rotate_y)": device_ms(lambda: transform(clouds, gen), 3),
             "group_points": device_ms(lambda: ops.group_points(tpts, G, M), 3),
             "model forward + backward": device_ms(fwd_bwd, 3),
             "AdamW (clip and step)": device_ms(lambda: opt.step(), 3),
             "whole step": device_ms(lambda: step(steps + 1), 3)}
    model.zero_grad(set_to_none=True)
    # device busy from the whole step's window, which device_ms accepts only
    # when every kernel name was recorded a whole number of times a step
    busy = parts["whole step"]
    dev_txt = (f"device busy {busy:.3f} ms a step ({len(ev) // 3} kernels), idle share "
               f"{1 - busy / med:.3f}" if busy else "device busy not measured")
    print(f"[time] finetune step B={bs}: median {med:.3f} ms, min {min(run.step_ms):.3f}, "
          f"max {max(run.step_ms[FT_WARM_STEPS:]):.3f} over {FT_TIMED_STEPS} (after "
          f"{FT_WARM_STEPS} warm-up); {bs / med * 1e3:.1f} clouds/s; {dev_txt}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    print("[time] finetune step top kernels (ms a step): "
          + "; ".join(f"{n[:60]} {t:.4f}" for n, t in top), flush=True)
    print("[time] finetune step parts (device ms): " + ", ".join(
        f"{k} {v if v is None else round(v, 5)}" for k, v in parts.items()), flush=True)

    # -- 18. validate at B=64 and the vote, kernel path against plain path ------
    model.eval()
    _backend.reset_launches()
    t0 = time.perf_counter()
    logits_k, labs = predict(model, val, npoints, dev)  # ends in a copy to the host
    val_s = time.perf_counter() - t0
    check_launches("validate", dict(_backend.LAUNCHES), FT_VALIDATE_PER_BATCH, len(val))
    with patched(serve, furthest_point_sample=ops.furthest_point_sample_ref,
                 gather_coords=ops.gather_points), patched(ops, group_points=ops.group_points_ref):
        _backend.reset_launches()
        logits_p, _ = predict(model, val, npoints, dev)
        if any(_backend.LAUNCHES.values()):
            fail(f"the plain-version validate launched kernels: {_backend.LAUNCHES}")
    swaps = 0
    for j, b in enumerate(val):  # the tie swaps of every FPS launch of the validation
        r, n_sw = check_fps(torch.from_numpy(b[2][0]).to(dev), npoints, "validation", False)
        swaps += n_sw + check_fps(ops.gather_points(torch.from_numpy(b[2][0]).to(dev), r), G,
                                  "validation groups", False)[1]
    hold_equal(f"validate logits ({len(val)} batches of {vbs})", logits_k, logits_p, swaps)
    preds = logits_k.argmax(-1)
    oa = float((preds == labs).mean()) * 100.0
    macc = balanced_accuracy(labs, preds) * 100.0
    print(f"[finetune] validate on {len(preds)} test clouds at B={vbs}: OA {oa:.4f}, mAcc "
          f"{macc:.4f}; {len(preds) / val_s:.1f} clouds/s ({val_s * 1e3:.1f} ms host)",
          flush=True)
    if not (math.isfinite(oa) and math.isfinite(macc)):
        fail("validate: metrics not finite")
    with torch.inference_mode():
        _backend.reset_launches()
        probs_k = vote_logits(model, vclouds, npoints, vote_generator(0, 0, 0, dev))
        check_launches("vote_logits", dict(_backend.LAUNCHES), FINETUNE_PER_STEP, VOTE_TIMES)
        with patched(ops, fps_subsample=fps_subsample_plain, group_points=ops.group_points_ref):
            _backend.reset_launches()
            probs_p = vote_logits(model, vclouds, npoints, vote_generator(0, 0, 0, dev))
            if any(_backend.LAUNCHES.values()):
                fail(f"the plain-version vote launched kernels: {_backend.LAUNCHES}")
        # the vote's draws replayed, to count the tie swaps of its FPS launches
        gen = vote_generator(0, 0, 0, dev)
        vswaps = check_fps(vclouds, n_fps, "vote resample", False)[1] * VOTE_TIMES
        for _ in range(VOTE_TIMES):
            moved = scale_and_translate(fps_subsample_plain(vclouds, n_fps, npoints, gen), gen)
            vswaps += check_fps(moved.contiguous(), G, "vote groups", False)[1]
    hold_equal(f"vote summed probabilities ({VOTE_TIMES} votes)", probs_k, probs_p, vswaps)
    one = val[:1]
    t0 = time.perf_counter()
    vote_k = validate_vote(model, one, npoints, 0, device=dev)
    vote_ms = (time.perf_counter() - t0) * 1e3
    want = float((probs_k.argmax(-1).cpu().numpy() == one[0][2][1]).mean()) * 100.0
    rounds = test_vote_rounds(model, val, npoints, 0, FT_VOTE_ROUNDS, device=dev)
    print(f"[finetune] validate_vote on one batch of {vbs} ({VOTE_TIMES} votes): OA {vote_k} "
          f"(the compared probabilities give {want}); {vote_ms:.1f} ms host a vote batch; "
          f"test_vote_rounds ({FT_VOTE_ROUNDS} rounds on {len(preds)} clouds): "
          f"{rounds.tolist()}", flush=True)
    if vote_k != want or not all(math.isfinite(x) for x in rounds):
        fail("vote: validate_vote is not the compared vote, or a round is not finite")

    return rows, errs, launches


def chain_shapes(dev, measure):
    """Phase 19: the launch shapes that the Stage-I and Stage-II trainers add,
    each against its plain version and timed: the SVM probe's resample of a
    batch of 256 ModelNet clouds, FPS (256, 8192)->1024 and its gather, then
    its grouping (FPS (256, 1024)->64, k-smallest (16384, 1024) k=32, the
    gathers by (256, 64) and (256, 2048)); and the Gumbel kernel at one
    cloud's tokenizer logits, (64, 8192) bf16. Returns (timing rows
    by kernel, errors)."""
    import numpy as np
    import torch
    from act_tpu_torch import ops
    from act_tpu_torch.datasets import build_dataset_from_cfg, synthetic_cloud
    from act_tpu_torch.engine.serve import load_config
    from act_tpu_torch.ops.fps import tie_swaps

    cfg = load_config(PRETRAIN_CONFIG)
    npts = int(cfg.dataset.val.others.npoints)
    dc = cfg.model.dvae_config
    G, M, V = int(dc.num_group), int(dc.group_size), int(dc.num_tokens)
    Bp = PROBE_BATCH
    clouds = torch.from_numpy(np.stack([synthetic_cloud(i, N_IN, PROBE_CLASSES)[0]
                                        for i in range(Bp)])).to(dev)
    errs = {}
    with torch.inference_mode():
        def check_fps(p, S):
            k, r = ops.furthest_point_sample(p, S), ops.furthest_point_sample_ref(p, S)
            n_sw = tie_swaps(k, r)
            if n_sw < 0 or not torch.equal(k.sort(-1).values, r.sort(-1).values):
                fail(f"fps probe {tuple(p.shape)}->{S}: kernel picks differ beyond tie swaps")
            errs[f"fps probe {tuple(p.shape)}->{S}"] = float(
                (ops.gather_points(p, k) - ops.gather_points(p, r)).abs().max())
            print(f"[check] fps probe {tuple(p.shape)}->{S}: equal up to {n_sw} adjacent tie "
                  "swaps (same set)", flush=True)
            return r
        rs = check_fps(clouds, npts)
        pts = ops.gather_points(clouds, rs)
        rc = check_fps(pts, G)
        d = ops.square_distance(ops.gather_points(pts, rc), pts).reshape(Bp * G, npts)
        (kv, ki), (rv, ri) = ops.k_smallest(d, M), ops.k_smallest_ref(d, M)
        if not (torch.equal(ki, ri) and torch.equal(kv, rv)):
            fail(f"k_smallest probe {tuple(d.shape)} k={M}: differs from the plain version")
        errs[f"k_smallest probe {tuple(d.shape)}"] = 0.0
        print(f"[check] k_smallest probe {tuple(d.shape)} k={M}: indices equal, values "
              "bit-equal", flush=True)
        gathers = [(clouds, rs), (pts, rc), (pts, ri.reshape(Bp, G * M))]
        for p, i in gathers:
            if not torch.equal(ops.gather_coords(p, i), ops.gather_points(p, i)):
                fail(f"gather probe {tuple(p.shape)} by {tuple(i.shape)}: not bit-equal")
            errs[f"gather probe {tuple(i.shape)}"] = 0.0
        print("[check] gather probe: bit-equal at " + ", ".join(
            f"{tuple(p.shape)} by {tuple(i.shape)}" for p, i in gathers), flush=True)
        g = torch.Generator(device=dev).manual_seed(19)
        logits = torch.randn(G, V, generator=g, device=dev).to(torch.bfloat16)
        seeds = [torch.tensor(w, dtype=torch.int32, device=dev) for w in ([0, 0], [7, -3])]
        for seed in seeds:
            if not torch.equal(ops.gumbel_argmax(logits, seed), ops.gumbel_argmax_ref(logits, seed)):
                fail(f"gumbel_argmax ({G}, {V}) bf16 seed {seed.tolist()}: ids differ")
        errs[f"gumbel_argmax one cloud ({G}, {V})"] = 0.0
        print(f"[check] gumbel_argmax ({G}, {V}) bf16 (one cloud's tokenizer logits), "
              f"seeds {[s.tolist() for s in seeds]}: ids equal (tolerance: exact); the grid's "
              "small regime (a block for every 8 rows, not the persistent grid of the Stage-II "
              "launch), which the tokenizer of one cloud (forward_tokenizer_features at B=1) "
              "launches; the trainers do not: Stage-I validation takes its hard pick as the "
              "argmax of the soft-Gumbel one-hot (the JAX dVAE's __call__)", flush=True)
        rows = {
            "fps": [measure(
                f"({p.shape[0]}, {p.shape[1]}, 3)->{S} (probe)",
                lambda p=p, S=S: ops.furthest_point_sample(p, S),
                lambda p=p, S=S: ops.furthest_point_sample_ref(p, S), None, 10, 1,
                bound_ms(p.numel() * 4 + p.shape[0] * S * 4,
                         10.0 * p.shape[0] * (S - 1) * p.shape[1]))
                for p, S in ((clouds, npts), (pts.contiguous(), G))],
            "k_smallest": [measure(
                f"({d.shape[0]}, {d.shape[1]}) k={M} (probe)", lambda: ops.k_smallest(d, M),
                lambda: ops.k_smallest_ref(d, M),
                lambda: torch.topk(d, M, dim=-1, largest=False, sorted=True), 50, 5,
                bound_ms(d.numel() * 4 + d.shape[0] * M * 8, d.numel()))],
            "gather": [measure(
                f"{tuple(p.shape)} by {tuple(i.shape)}, {distinct_rows(i)} rows read (probe)",
                lambda p=p, i=i: ops.gather_coords(p, i), lambda p=p, i=i: ops.gather_points(p, i),
                lambda p=p, li=i.long().reshape(Bp, -1, 1).expand(-1, -1, 3).contiguous():
                torch.gather(p, 1, li), 100, 100,
                bound_ms(distinct_rows(i) * 12 + i.numel() * 4 + i.numel() * 12))
                for p, i in ((q.contiguous(), j.contiguous()) for q, j in gathers)],
            "gumbel_argmax": [measure(
                f"({G}, {V}) bf16 (one cloud's tokenizer)",
                lambda: ops.gumbel_argmax(logits, seeds[0]),
                lambda: ops.gumbel_argmax_ref(logits, seeds[0]), None, 100, 10,
                bound_ms(logits.numel() * 2 + G * 4, GUMBEL_OPS * logits.numel()), 0)],
        }
    print_times("chain ", rows)
    return rows, errs


def chain(dev):
    """Phases 20-24: the user's pipeline through the trainers' entry points
    at full width, every checkpoint under a temporary directory deleted
    afterwards. 20: Stage I, ``runner_autoencoder.run_net`` for one epoch of
    at most 4 steps through the ShapeNet-55 loader, validation on 16 test
    clouds, ckpt-best and ckpt-last; its resume for one more epoch; then
    ``test_net`` of ckpt-best with its dumps. 21: Stage II,
    ``runner_pretrain.run_net`` with ``dvae_config.ckpt`` the Stage-I
    ckpt-best, 3 steps, the SVM probe on the ModelNet40 ``extra_train`` and
    ``val`` splits, ckpt-best and ckpt-last; the frozen tokenizer the
    Stage-I weights in bf16 before and after. 22: the probe's features
    through the kernels against the plain path. 23: one finetune step from
    the Stage-II checkpoint. 24: the clouds/s of the trainers' loaders
    (``builder.dataset_builder``). Returns (launches of each run, errors)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from act_tpu_torch import ops
    from act_tpu_torch.datasets import build_dataset_from_cfg, synthetic_cloud
    from act_tpu_torch.engine import builder
    from act_tpu_torch.engine import checkpoint as ckpt_lib
    from act_tpu_torch.engine import runner_autoencoder, runner_finetune, runner_pretrain
    from act_tpu_torch.engine.serve import load_config, load_state_dict
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.ops.fps import tie_swaps
    from act_tpu_torch.utils.config import ConfigDict

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    errs, runs = {}, {}

    def counted(tag, fn):
        _backend.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        runs[tag] = dict(_backend.LAUNCHES)
        print(f"[chain] {tag}: {time.perf_counter() - t0:.2f} s; launches {runs[tag]}",
              flush=True)
        return out

    def expect(tag, *parts):
        want = {}
        for per, units in parts:
            for k, v in per.items():
                want[k] = want.get(k, 0) + v * units
        check_launches(tag, runs[tag], want, 1)

    def tokenizer_equals_stage_one(model, source, when):
        tok = {k[len(runner_pretrain.TOKENIZER) + 1:]: v for k, v in model.state_dict().items()
               if k.startswith(runner_pretrain.TOKENIZER + ".") and "running" not in k
               and "num_batches" not in k}
        same = all(torch.equal(v, source[k].to(v.device, v.dtype)) for k, v in tok.items())
        n16 = sum(v.dtype == torch.bfloat16 for v in tok.values())
        print(f"[chain] Stage-II tokenizer {when} the steps: {len(tok)} tensors ({n16} bf16) "
              f"bit-equal to the Stage-I ckpt-best's cast to their dtype: {same}", flush=True)
        if not same:
            fail(f"Stage II: the frozen tokenizer differs from the Stage-I weights {when}")

    try:
        # -- 20. Stage I: run_net, resume, test_net ----------------------------
        t_phase = time.perf_counter()
        s1 = os.path.join(tmp, "stage1")
        acfg = load_config(AUTOENCODER_CONFIG)
        res1 = counted("Stage-I run_net", lambda: runner_autoencoder.run_net(
            AUTOENCODER_CONFIG, device=dev, epochs=1, max_steps=S1_RUN_STEPS,
            max_val=S1_RUN_VAL, experiment_path=s1))
        expect("Stage-I run_net", (STAGE1_PER_STEP, S1_RUN_STEPS),
               (VALIDATE_PER_CLOUD, S1_RUN_VAL))
        vals = list(res1.best_metrics.state_dict().values())
        table = res1.best_metrics.table
        print(f"[chain] Stage I: {res1.step} steps, anneal iteration {res1.n_itr}, losses "
              f"(x1000) {res1.epoch_losses}, best {res1.best_metrics.state_dict()} over "
              f"{sum(n for n, _ in table.values())} clouds in {len(table)} categories", flush=True)
        if not (res1.step == res1.n_itr == S1_RUN_STEPS and all(map(math.isfinite, vals))
                and all(math.isfinite(x) for x in res1.epoch_losses[0])):
            fail("Stage-I run_net: steps, anneal iteration or metrics wrong")
        for name in ("ckpt-best", "ckpt-last"):
            if not os.path.exists(ckpt_lib.ckpt_path(s1, name)):
                fail(f"Stage-I run_net: no {name}")
        epoch_steps = 512 // int(acfg.total_bs)  # the synthetic ShapeNet-55 at B=64
        res1b = counted("Stage-I resume", lambda: runner_autoencoder.run_net(
            AUTOENCODER_CONFIG, device=dev, epochs=2, max_steps=S1_RUN_STEPS,
            max_val=S1_RESUME_VAL, resume=True, experiment_path=s1))
        expect("Stage-I resume", (STAGE1_PER_STEP, S1_RUN_STEPS),
               (VALIDATE_PER_CLOUD, S1_RESUME_VAL))
        last = torch.load(ckpt_lib.ckpt_path(s1, "ckpt-last"), map_location="cpu",
                          weights_only=True)
        want_temp = runner_autoencoder.get_temp(acfg, epoch_steps)
        print(f"[chain] Stage-I resume: epoch {last['epoch']}, step {res1b.step}, anneal "
              f"iteration {res1b.n_itr} (epoch 1 starts at {epoch_steps} = 1 x "
              f"len(train_loader)), temperature {res1b.temps[0]} (get_temp {want_temp})",
              flush=True)
        if not (last["epoch"] == 1 and res1b.step == last["step"] == 2 * S1_RUN_STEPS
                and res1b.n_itr == epoch_steps + S1_RUN_STEPS and res1b.temps[0] == want_temp):
            fail("Stage-I resume: epoch, step or anneal iteration did not continue")
        best1 = ckpt_lib.ckpt_path(s1, "ckpt-best")
        m_test = counted("Stage-I test_net", lambda: runner_autoencoder.test_net(
            AUTOENCODER_CONFIG, ckpts=best1, device=dev, experiment_path=s1,
            max_batches=S1_TEST_CLOUDS, max_dumps=S1_TEST_CLOUDS))
        expect("Stage-I test_net", (VALIDATE_PER_CLOUD, S1_TEST_CLOUDS),
               (RECON_PER_CLOUD, S1_TEST_CLOUDS))
        vis = sorted(os.listdir(os.path.join(s1, "vis")))
        dense = np.loadtxt(os.path.join(s1, "vis", vis[0]))
        G1, M1 = int(acfg.model.num_group), int(acfg.model.group_size)
        print(f"[chain] Stage-I test_net: {m_test.state_dict()}; dumps {vis}; {vis[0]} "
              f"{dense.shape}; phase 20 {time.perf_counter() - t_phase:.1f} s", flush=True)
        if not (len(vis) == 2 * S1_TEST_CLOUDS and dense.shape == (G1 * M1, 3)
                and np.isfinite(dense).all()):
            fail("Stage-I test_net: dumps missing or malformed")

        # -- 21. Stage II on the Stage-I tokenizer ----------------------------
        t_phase = time.perf_counter()
        s2 = os.path.join(tmp, "stage2")
        pcfg = load_config(PRETRAIN_CONFIG)
        pcfg.model.dvae_config.ckpt = best1
        source = load_state_dict(best1)
        before = runner_pretrain.prepare_model(pcfg, 0, dev)
        tokenizer_equals_stage_one(before, source, "before")
        res2 = counted("Stage-II run_net", lambda: runner_pretrain.run_net(
            pcfg, device=dev, epochs=1, max_steps=S2_RUN_STEPS, experiment_path=s2))
        n_probe = sum(-(-len(build_dataset_from_cfg(pcfg.dataset[n])) // PROBE_BATCH)
                      for n in ("extra_train", "val"))
        expect("Stage-II run_net", (STAGE2_PER_STEP, S2_RUN_STEPS), (PROBE_PER_BATCH, n_probe))
        tokenizer_equals_stage_one(res2.model, source, "after")
        moved = not torch.equal(before.state_dict()["proj_head.weight"],
                                res2.model.state_dict()["proj_head.weight"])
        probe = res2.probes[0]
        print(f"[chain] Stage II: {res2.step} steps, loss {res2.epoch_loss}, student moved "
              f"{moved}; SVM probe accuracy {probe.acc:.4f} % ({n_probe} batches of "
              f"{PROBE_BATCH}), {probe.svm_iters} Newton iterations, relative gradient norm "
              f"{probe.svm_rel_grad:.3e} (tolerance 1e-6); phase 21 "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        if not (moved and all(map(math.isfinite, res2.epoch_loss)) and math.isfinite(probe.acc)
                and probe.svm_rel_grad <= 1e-6):
            fail("Stage-II run_net: student, loss or probe wrong")
        for name in ("ckpt-best", "ckpt-last"):
            if not os.path.exists(ckpt_lib.ckpt_path(s2, name)):
                fail(f"Stage-II run_net: no {name}")
        del before

        # -- 22. probe features through the kernels and through the plain path
        labels = np.arange(PROBE_BATCH) % PROBE_CLASSES
        pclouds = np.stack([synthetic_cloud(i, N_IN, PROBE_CLASSES)[0]
                            for i in range(PROBE_BATCH)])
        batch = [(None, None, (pclouds, labels))]
        vnp = int(pcfg.dataset.val.others.npoints)
        G2 = int(pcfg.model.dvae_config.num_group)
        feats_k = counted("probe features", lambda: runner_pretrain.probe_features(
            res2.model, batch, vnp)[0])
        expect("probe features", (PROBE_PER_BATCH, 1))
        with patched(ops, furthest_point_sample=ops.furthest_point_sample_ref,
                     gather_coords=ops.gather_points, group_points=ops.group_points_ref):
            feats_p = counted("probe features, plain", lambda: runner_pretrain.probe_features(
                res2.model, batch, vnp)[0])
        if any(runs["probe features, plain"].values()):
            fail("the plain-version probe features launched kernels")
        with torch.inference_mode():
            pc = torch.from_numpy(pclouds).to(dev)
            k, r = ops.furthest_point_sample(pc, vnp), ops.furthest_point_sample_ref(pc, vnp)
            swaps = tie_swaps(k, r)
            q = ops.gather_points(pc, r)
            swaps += tie_swaps(ops.furthest_point_sample(q, G2),
                               ops.furthest_point_sample_ref(q, G2))
        diff = float(np.abs(feats_k - feats_p).max())
        apart = float(np.abs(feats_k[1:] - feats_k[:-1]).max(axis=1).min())
        errs["probe features"] = diff
        tol = 0.0 if swaps == 0 else FEAT_ATOL
        print(f"[chain] probe features {feats_k.shape} through the kernels against the plain "
              f"path: max |diff| {diff} (tolerance {tol}: {swaps} FPS tie swaps); neighbouring "
              f"clouds' rows at least {apart} apart", flush=True)
        if not (np.isfinite(feats_k).all() and diff <= tol and apart > 0):
            fail("probe features: kernel path and plain path disagree")

        # -- 23. one finetune step from the Stage-II checkpoint ------------------
        t_phase = time.perf_counter()
        best2 = ckpt_lib.ckpt_path(s2, "ckpt-best")
        fcfg = runner_finetune.finetune_config(CONFIG)
        st = runner_finetune.build_state(fcfg, 1, 0, dev, ckpts=best2)
        saved = load_state_dict(best2)
        student = [k for k in saved if k.startswith("ACT_encoder.")
                   and not k.startswith("ACT_encoder.cls_head.")]  # its pretraining head
        lifted = ckpt_lib.strip_student_prefix(saved)
        state = st.model.state_dict()
        merged = [n for n, v in lifted.items()
                  if n in state and tuple(v.shape) == tuple(state[n].shape)]
        same = all(torch.equal(state[n].cpu(), lifted[n].to(state[n].dtype)) for n in merged)
        run = counted("finetune step from Stage II", lambda: runner_finetune.run_finetune_steps(
            CONFIG, 1, device=dev, state=st))
        expect("finetune step from Stage II", (FINETUNE_PER_STEP, 1))
        print(f"[chain] finetune from {os.path.basename(best2)}: {len(merged)} tensors merged "
              f"of the student's {len(student)} (prefix lifted), equal to the checkpoint's before "
              f"the step: {same}; one "
              f"step, loss {run.losses[0]:.6f}; phase 23 {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        if not (same and len(merged) == len(student) and math.isfinite(run.losses[0])):
            fail("finetune from the Stage-II checkpoint: merge or step wrong")
        del st, run, res1, res1b, res2

        # -- 24. the loader: clouds/s -------------------------------------------
        rng = np.random.default_rng(0)
        data, pcdir = os.path.join(tmp, "ShapeNet-55"), os.path.join(tmp, "shapenet_pc")
        os.makedirs(data)
        os.makedirs(pcdir)
        names = [f"{i % 55:08d}-m{i:04d}.npy" for i in range(LOADER_CLOUDS)]
        for n in names:
            np.save(os.path.join(pcdir, n), rng.normal(size=(N_IN, 3)).astype(np.float32))
        with open(os.path.join(data, "train.txt"), "w") as f:
            f.write("".join(n + "\n" for n in names))
        npts = int(pcfg.dataset.train.others.npoints)
        node = ConfigDict({"_base_": dict(NAME="ShapeNet", N_POINTS=N_IN, DATA_PATH=data,
                                          PC_PATH=pcdir),
                           "others": dict(subset="train", npoints=npts, bs=LOADER_BATCH)})
        rates = {}
        for workers in (0, LOADER_WORKERS):
            loader = builder.dataset_builder(node, 0, workers)[1]
            try:
                list(loader)  # warm: the file cache, the pool
                t0, n = time.perf_counter(), 0
                for epoch in (1, 2):
                    loader.set_epoch(epoch)
                    n += sum(len(b[2]) for b in loader)
                rates[f".npy, {workers} workers"] = n / (time.perf_counter() - t0)
            finally:
                loader.close()
        synth = builder.dataset_builder(ConfigDict(
            {"_base_": dict(NAME="ShapeNet", N_POINTS=N_IN, DATA_PATH="data/absent",
                            PC_PATH="data/absent"),
             "others": dict(subset="train", npoints=npts, whole=True,
                            bs=int(pcfg.total_bs))}), 0, LOADER_WORKERS)[1]
        t0 = time.perf_counter()
        n = sum(len(b[2]) for _, b in zip(range(2), synth))
        rates["synthetic, in process"] = n / (time.perf_counter() - t0)
        print(f"[time] loader ({N_IN}-point clouds to {npts}, batches of {LOADER_BATCH}; "
              "at 0 workers built in process, with no prefetch thread; "
              f"{LOADER_CLOUDS} .npy clouds, two epochs after a warm one; synthetic: 2 "
              f"batches of {int(pcfg.total_bs)}): " + ", ".join(
                  f"{k} {v:.1f} clouds/s" for k, v in rates.items()), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs, errs


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

    # -- 19. the trainers' new launch shapes, timed while the profiler's windows
    # are still whole (late windows of a process have come back incomplete)
    chain_rows, c_errs = chain_shapes(dev, measure)
    errs.update(c_errs)

    # -- 6-10. Stage-II pretraining ----------------------------------------------
    stage2, s2_errs, s2_launches = stage_two(dev, device_ms, kernel_events, measure)
    errs.update(s2_errs)
    # -- 11-14. Stage-I autoencoder training and its metrics ------------------------
    stage1, s1_errs, s1_launches, val_launches = stage_one(dev, device_ms, kernel_events,
                                                           measure)
    errs.update(s1_errs)
    # -- 15-18. classification finetune, validation and the vote ------------------
    ft_rows, ft_errs, ft_launches = finetune(dev, device_ms, kernel_events, measure)
    errs.update(ft_errs)
    # -- 20-24. the Stage-I -> Stage-II -> finetune chain and the loader ---------
    chain_runs, chain_errs = chain(dev)
    errs.update(chain_errs)
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
            "launches_finetune": ft_launches[kernel],
            "launches_chain": {tag: n[kernel] for tag, n in chain_runs.items()},
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
                                                 else stage1.get(kernel, [])),
                                                ("finetune", ft_rows.get(kernel, [])),
                                                ("chain", chain_rows.get(kernel, [])))
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
