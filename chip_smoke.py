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
  kernels and the row-gather backward (the DGCNN's four rounds) against
  their plain versions, one train-mode loss and backward through the kernels
  and one through the plain versions, then ``run_autoencoder_steps`` for a
  few train steps, one step rerun from the same state bit for bit, and
  ``validate`` (the reconstruction metrics);
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
- part and semantic segmentation (``SegBackbone`` 384 x 12, G=128 groups of
  32, clouds of 2048 points, bf16, seeded weights, synthetic ShapeNetPart and
  S3DIS data): FPS, k-smallest (k=32 and the 3-NN's k=3) and the gathers at
  the part-seg (B=16), sem-seg (B=32) and whole-scene (16 blocks) shapes and
  ``three_nn_interpolate`` and the 3-NN's row-gather backward, each against
  its plain version; both models' eval forwards through the kernels and
  through the plain versions, the request times and ``serve_http``'s
  segmentation kind; one part-seg train-mode loss and backward through both;
  ``run_partseg`` and ``run_semseg`` for a few steps and an evaluation each
  with ckpt-best reloaded, one step of each rerun from the same state bit for
  bit; ``whole_scene_eval`` with the blocks batched against one block a
  forward;
- ``ACT_PointBERT`` at ``pretrain_act_distill.yaml`` with the PointBERT
  overrides of ``tools/bench_suite.py`` (B=128 clouds of 1024 points, the q and
  k 384 x 12 MaskTransformers with the 8192-way f32 ``lm_head``, the frozen
  bf16 tokenizer of which the encoder and dgcnn_1 label the groups, K=16384,
  m=0.999, seeded weights, synthetic clouds): ``forward_eval`` features
  through the kernels and the plain versions and over HTTP, one train-mode
  loss and backward through both, ``run_steps`` with the EMA of k held to its
  host recomputation, and ``run_net`` with the SVM probe and a resume that
  restores the MoCo queue;
- the Stage-I tokenizer served (``tokenize`` and ``dvae``), Stage I with the
  CLIP and BERT teachers and Stage II on the CLIP tokenizer (phases 33-35);
- ModelNet40 at 8192 points (phases 39-41, ``--modelnet8k``): the offline FPS
  cache of a written synthetic ``modelnet40_normal_resampled`` tree built
  through the FPS kernel, its picks held to the plain version; the shipped
  ``finetune_modelnet_8k.yaml`` (384 x 12, G=128, B=32) through the kernels
  at its shapes against the plain versions, train steps, validation, a vote
  round, ``test_net``, requests at B=1 and 32, and a step each of its linear
  and mlp-3 variants; SGD with StepLR and ``step_per_update`` 2, its weights
  still between updates, stopped by the preemption guard between updates and
  resumed bit-equal;
- t-SNE at ``tsne_scan_hardest.yaml`` (two 384 x 12 PointTransformers, 2048
  points, seeded weights): both models' features through the kernels and the
  plain versions, ``tsne_net``, the embedding of 2882 features on the card,
  and of the first 1024 against a CPU run (phase 36; the CPU run on a thread
  of this process, beside phase 37's tracing);
- every serving forward exported (``engine/export.py``) on the card at B=32
  and with a symbolic batch, reloaded in a process that imports no model
  code, bit-equal to its direct call, its kernels in the call's profile,
  served over HTTP (``serve_http``; the first through ``--src``) (phase 37;
  every kind but the classifier with its transformers at 2 blocks, widths
  kept);
- data parallelism and preemption (phase 38, ``--ddp``): the finetune (B=32),
  Stage-II (B=128), Stage-I (B=64), part-seg (B=16), sem-seg (B=32) and
  ACT_PointBERT (B=128, its MoCo queue) steps over two ranks sharing the
  card over gloo against one rank on the same global batches, every kernel
  of the paths launched on both ranks; one rank over NCCL (``run_net`` and
  the steps) bit-equal to the run without a group, with its step times and
  NCCL kernels; the finetune CLI stopped by a real SIGTERM and resumed, and
  Stage II stopped by the step hook and resumed, each bit-equal to an
  uninterrupted run; the part-seg CLI under ``torch.distributed.run`` with
  2 ranks (the CLIs and the ``run_net`` legs run beside phase 37's tracing,
  every timed section alone on the card); leg (t): the same two ranks as a
  tensor-parallel grid of data 1 x model 2 (``--mesh_model_parallel 2``),
  the six trainers' steps on the whole global batch against the run without
  a group, replicated tensors bit-equal over the ranks, the kernels of the
  no-group step launched, each trainer's full-layout checkpoint loaded by a
  model without a group, and the finetune CLI under
  ``torch.distributed.run`` at ``--mesh_model_parallel 2``; every model of
  phase 38 with its transformers at 2 blocks (segmentation 4), widths kept;

- the MODEL_ZOO parity protocol (phase 42, ``--parity``, beside phase 37's
  tracing): fabricated full-width released-layout ``.pth`` files through every
  row of ``act_tpu_torch.parity_protocol`` (the three ScanObjectNN rows,
  ModelNet40 with and without ``--from_pretrain --vote``, fold 0 of the four
  few-shot rows, S3DIS, the dVAE) on synthetic data, length cut only, each row's
  kernels launched, the ``scan_hardest`` test OA against a CPU run of the same
  batches, and the part-seg dumps of ``part_segmentation_vis``; then the
  linear and mlp-3 variants of the 1k ModelNet, the ScanObjectNN and the
  few-shot configs, each for two steps and a test batch (phase 46);
- Point-BERT's plain ``DiscreteVAE`` at ``pointbert_dvae.yaml`` uncut (phase
  43, ``--plain-dvae``): its kernels at the path's shapes, one loss and
  backward through the kernels and the plain versions, timed
  ``run_autoencoder_steps``, a rerun bit-equal, ``validate``; and beside
  phase 37's tracing (phase 44, ``--plain-dvae-cli``) its CLI trained,
  resumed and tested, the checkpoint served as ``tokenize`` and ``dvae``
  over HTTP against the plain path;
- ``act_tpu_torch.get_flops`` on every shipped model YAML, on the card and
  on the CPU, the counts equal exactly (phase 45, ``--flops``, beside phase
  37's tracing);
- the per-op device profile of the full-width Stage-II step
  (``act_tpu_torch.profile_step``: its kernel table's launches against
  ``STAGE2_PER_STEP``, its total against ``device_ms``), Stage II's
  ``run_net`` with ``ACT_TPU_PROFILE`` set (one trace of the steps of JAX's
  window [10, 15), bit-equal to the run without it) and
  ``utils.misc.random_dropping`` against its plain version (phase 47,
  ``--profile``, a child alone on the card);
- the measurement tools (phase 48, ``--bench``, a child alone on the card):
  ``act_tpu_torch.bench``'s headline line at full width (its ``mfu``, its
  FLOP count against the CPU's at B=1), ``bench_suite``'s two forwards and
  three microbenches (each against its plain version), ``bench_sustained``
  on a small ShapeNet-55 tree (the loader at 0 and 8 workers, ``run_net``),
  ``graft_entry.entry()`` at full width and ``dryrun_multichip(2)`` on two
  gloo ranks sharing the card;

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
import shutil
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
# relative L2 norm: within GRAD_RTOL on the loss's side of the bf16 teacher (the
# decoder, dgcnn_2); upstream of it every bf16 rounding through its 12 frozen
# blocks can move an element by one bf16 ulp (2^-8), so the gap to the plain path
# is held to SPREAD_FACTOR times the spread of two kernel-path runs, and never
# below GRAD_RTOL. Two kernel-path runs differed by about 1 % upstream while the
# DGCNN's torch.gather backward added with atomics; with the row gathers' fixed
# order (and the plain Chamfer backward's ascending sums, on the card too) both
# runs and both paths are bit-equal on the H100.
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
# the TPU kernel (its pallas_call function) that each port kernel replaces
REPLACES = {"fps": "act_tpu/ops/fps.py:98", "k_smallest": "act_tpu/ops/topk.py:33",
            "gather": "act_tpu/ops/gather.py:25", "gumbel_argmax": "act_tpu/ops/sampling.py:50",
            "chamfer_nn": "act_tpu/ops/chamfer.py:33",
            "chamfer_nn_min": "act_tpu/ops/chamfer.py:167",
            "chamfer_bwd": "act_tpu/ops/chamfer.py:341 (_chamfer_bwd)",
            "row_gather_bwd": "none: no Pallas counterpart; it repairs the port's own "
                              "torch.gather / index_select backward (the DGCNN's neighbour rows, "
                              "the 3-NN blend's feature rows), whose atomics add in a changing "
                              "order"}
SERVE_KERNELS = ("fps", "k_smallest", "gather")  # the kernels of the serving path
# kernel launches a train step (or a validation cloud) of each training path
STAGE2_PER_STEP = {"fps": 1, "k_smallest": 3, "gather": 2, "gumbel_argmax": 1}
# a Stage-I step: group_points, dgcnn_1's and dgcnn_2's kNN, the two recon Chamfer losses,
# and the backward of the two DGCNNs' four neighbour-row gathers each
STAGE1_PER_STEP = {"fps": 1, "k_smallest": 3, "gather": 2, "chamfer_nn": 2, "chamfer_bwd": 2,
                   "row_gather_bwd": 8}
# the row-gather backward at the Stage-I DGCNN's four rounds (C of each round's input
# features; dgcnn_1 and dgcnn_2 alike) and its bound
DGCNN_ROUND_C = (128, 256, 512, 512)
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
# the segmentation path (phases 25-28): part seg on 16 clouds, sem seg on 32
# blocks, the whole-scene vote on 16 blocks, 2048 points each, G=128 x M=32
SEG_NPOINT, SEG_GROUPS, SEG_GROUP_SIZE = 2048, 128, 32
SEG_PART_B, SEG_SEM_B, SEG_BLOCKS = 16, 32, 16
# a forward: group_points' FPS, k=32 kNN and two gathers, then the 3-NN's k=3
# k-smallest; a train step also the backward of the 3-NN blend's three row gathers
SEG_PER_FORWARD = {"fps": 1, "k_smallest": 2, "gather": 2}
SEG_PER_STEP = {**SEG_PER_FORWARD, "row_gather_bwd": 3}
# bf16 eval log-probs, kernel path against plain path: bit-equal unless an FPS
# tie swap reorders the groups (then bf16 sums in another order)
SEG_LOGP_ATOL = 0.05
SEG_GRAD_KEYS = ("convs3.weight", "convs1.weight", "label_conv.0.weight",
                 "propagation_0.mlp_convs.0.weight", "blocks.blocks.11.mlp.fc2.weight",
                 "blocks.blocks.0.attn.qkv.weight", "pos_embed.0.weight",
                 "encoder.first_conv.0.weight")
SEG_RUN_STEPS, SEG_RUN_EVAL, SEG_TIMED_STEPS = 3, 2, 8
SEG_HTTP_BATCH = 2
# whole-scene votes (a point's probabilities summed over the ~4 blocks that
# hold it), 16 blocks a forward against one: bf16 products at another batch
# size may round in another order (1.5e-5 to 2.3e-5 on the H100), while each
# block's probabilities added to its neighbour's points in the chunk move the
# votes by 0.79 (seeded weights, 256 points, on the CPU)
SEG_VOTE_ATOL = 1e-3
# ACT_PointBERT (phases 29-32): pretrain_act_distill.yaml with the overrides of
# tools/bench_suite.py's PointBERT setup (``profile_step.pointbert_config``: B=128
# clouds of 1024 points, the two 384 x 12 MaskTransformers with an 8192-way lm_head,
# the frozen tokenizer in bf16)
PB_FEAT_B, PB_HTTP_N = 32, 2048  # the features request's batch; HTTP clouds are resampled
# a train step: group_points' FPS, k=32 kNN and two gathers once (the q, mixup
# and k passes reuse the groups), then the tokenizer's dgcnn_1 k=4 kNN
POINTBERT_PER_STEP = {"fps": 1, "k_smallest": 2, "gather": 2}
FEATURES_PER_REQUEST = {"fps": 1, "k_smallest": 1, "gather": 2}  # N == npoints
FEATURES_RESAMPLED = {"fps": 2, "k_smallest": 1, "gather": 3}  # N != npoints
PB_GRAD_KEYS = ("transformer_q.lm_head.weight", "transformer_q.cls_head.2.weight",
                "transformer_q.blocks.blocks.11.mlp.fc2.weight",
                "transformer_q.blocks.blocks.0.attn.qkv.weight", "transformer_q.mask_token",
                "transformer_q.pos_embed.0.weight", "transformer_q.encoder.first_conv.0.weight")
PB_EMA_STEPS, PB_RUN_STEPS = 3, 3
# the dVAE tokenizer and its teachers (phases 33-35): the served Stage-I config
# at B=1 and TOK_B clouds of 1024 points; a request's launches (group_points'
# FPS, k=32 kNN and two gathers, then dgcnn_1's k=4 kNN; recon adds dgcnn_2's)
TOK_B, TOK_HTTP_B = 32, 2
# phase 36, t-SNE: the YAML, the test batches of tsne_net, the features embedded
# and timed (ScanObjectNN hardest's test split holds 2882 clouds), the first of
# them that the card and a CPU run both embed, and the card's final KL against
# the CPU run's (two runs of a chaotic descent in other rounding orders end in
# other local optima: on the H100 80GB HBM3 the two KLs of all 2882 features
# were 0.00685 apart, relative, in every run, each side being repeatable), held
# within about 3x that
TSNE_CONFIG = "cfgs/tsne/tsne_scan_hardest.yaml"
TSNE_BATCHES, TSNE_N, TSNE_REF_N, TSNE_KL_RTOL = 2, 2882, 1024, 0.02
# where phase 36's child leaves the TSNE_REF_N features and the card's KL, whose
# CPU t-SNE the parent runs on a thread beside phase 37's tracing (an environment
# variable holding a path)
TSNE_REF_ENV = "CHIP_SMOKE_TSNE_REFERENCE"
# extract_features with logits: the resample (FPS, gather), then group_points
# (FPS, k-smallest, 2 gathers) in extract_feature and again in the forward
TSNE_PER_BATCH = {"fps": 3, "k_smallest": 2, "gather": 5}
# phase 37, the artifacts: the fixed batch, the largest relative difference
# allowed where an exported graph decomposes an op, request timing iterations
EXPORT_B, EXPORT_RTOL, EXPORT_ITERS = 32, 1e-5, 20
# the paths that run their transformers (the students, the frozen teachers) at CUT_DEPTH
# blocks, widths kept (``cut_depth``; a segmentation backbone at CUT_SEG_WIDTHS), so that
# the script keeps within its budget: the chain (phases 20-24) and PointBERT's run_net
# (phase 32), whose checks (hand-overs, checkpoints, resumes) do not depend on depth;
# every artifact but the classifier (phase 37: the host replays each block's nodes in a
# call, so the depth sets the tracing, save and load seconds, not what the artifact
# checks); phase 38, whose held steps against one rank, faults and checkpoints do not
# depend on depth and whose gloo steps' times are not what DP and TP cost on NVLink
CUT_DEPTH = 2
CUT_SEG_WIDTHS = dict(depth=4, fetch_idx=[1, 2, 3])
# phase 47, the per-op profile and the trace window: the device functions of the
# Stage-II kernels as a trace names them; run_net's batch (512 synthetic clouds:
# 16 steps an epoch, past JAX's window of steps [10, 15)); random_dropping's shape
PROFILE_FUNCTIONS = {"fps": ("fps_kernel",),
                     "k_smallest": ("ksmallest_kernel", "ksmallest_small_kernel"),
                     "gather": ("gather_tile", "gather_element"),
                     "gumbel_argmax": ("gumbel_screen_kernel", "gumbel_exact_kernel")}
PROFILE_TOP, PROFILE_RTOL, PROFILE_SUM_RTOL = 15, 0.10, 0.01
TRACE_B, TRACE_WINDOW = 32, (10, 15)
DROP_SHAPE, DROP_G, DROP_M = (128, 1024, 3), 64, 32
DROP_PER_CALL = {"fps": 1, "k_smallest": 1, "gather": 2}
ADAMW_RANGE = "Optimizer.step#AdamW.step"
# phase 48, the measurement tools: bench's short run (the count's step, the warm-up and
# timed steps, then a device window of bench.DEVICE_STEPS and the first call outside it),
# the suite's rows that build no train step, the sustained tool on a small tree (256
# train + 128 test clouds: 3 steps an epoch at B=128), the dry run's ranks
BENCH_ARGS, BENCH_ENV = ["--warmup", "1"], {"BENCH_STEPS": "3"}
BENCH_MFU = (0.0, 1.05)
SUITE_ARGS = ["--only", "finetune_infer,semseg_eval,fps,knn,chamfer", "--steps", "3",
              "--warmup", "1", "--iters", "20"]
SUITE_KERNELS = ("fps", "k_smallest", "gather", "chamfer_nn_min")
SUSTAINED_ARGS = ["--files", "256", "--loader_batches", "2", "--epochs", "2"]
SUSTAINED_STEPS = 2 * ((256 + 128) // 128)
DRYRUN_RANKS = 2
MICRO_ATOL = 1e-6  # the kNN distances and the Chamfer loss against their plain versions
# the file whose existence tells phase 37's child that the work the parent ran
# beside its tracing (phase 36's CPU t-SNE, phase 38's CLIs) has ended, so that
# its timed requests run alone (an environment variable holding a path)
QUIET_ENV = "CHIP_SMOKE_QUIET_FILE"
TOKENIZE_PER_REQUEST = {"fps": 1, "k_smallest": 2, "gather": 2}
RECON_PER_REQUEST = {"fps": 1, "k_smallest": 3, "gather": 2}
# the Stage-I config's teacher swapped (visual_embed_type clip_* selects CLIP's
# visual transformer, reference dvae.py:394-410; the BERT class, dvae.py:617)
TEACHER_ARCHS = {"clip": dict(visual_embed_type="clip_ViT-B/16"),
                 "bert": dict(NAME="ACTPromptedDiscreteVAEwithBERT",
                              visual_embed_type="bert-base-uncased")}
TK_S1_STEPS, TK_S2_STEPS = 3, 2
# phases 39-41 (``--modelnet8k``, a child process): 39, the ModelNet offline FPS
# cache of a written synthetic modelnet40_normal_resampled tree (CACHE_CLOUDS files
# of CACHE_FILE_POINTS x 6 rows) through the card's FPS kernel, projected to
# ModelNet40's MODELNET_CLOUDS; 40, finetune_modelnet_8k.yaml at full width (and
# its linear and mlp-3 variants for a step each); 41, SGD + StepLR with
# step_per_update 2 on finetune_modelnet.yaml, stopped and resumed
CONFIG_8K = "cfgs/finetune_classification/full/finetune_modelnet_8k.yaml"
CONFIGS_8K_HEADS = ("cfgs/finetune_classification/linear/finetune_modelnet_8k_linear.yaml",
                    "cfgs/finetune_classification/mlp3/finetune_modelnet_8k_mlp3.yaml")
CACHE_CLOUDS, CACHE_FILE_POINTS, CACHE_CLASSES, MODELNET_CLOUDS = 64, 10000, 8, 12311
M8_STEPS, M8_VAL_BATCHES, M8_REQ_ITERS = 3, 2, (20, 10)
# a train step (and a vote) at 8192 points: the resample is a subset of the cloud
# itself (_point_all(8192) = 8192: no FPS, one gather, as in JAX), then
# group_points' FPS, k-smallest and two gathers; a validation batch or a request
# resamples by FPS 8192 -> 8192 first
FT8K_PER_STEP = {"fps": 1, "k_smallest": 1, "gather": 3}
FT8K_PER_EVAL = {"fps": 2, "k_smallest": 1, "gather": 3}
OPT_STEPS, OPT_EVERY, OPT_STOP = 4, 2, 3
# phase 42 (``--parity``, a child process beside phase 37's tracing): every
# MODEL_ZOO row of ``act_tpu_torch.parity_protocol`` on fabricated full-width
# released-layout .pth files and synthetic data, length cut only: PARITY_BATCHES
# test batches, PARITY_ROUNDS vote rounds, fold 0 of the few-shot rows for one
# epoch of PARITY_STEPS steps, one S3DIS scene with one vote round, PARITY_DVAE
# validation clouds; then the part-seg dumps of PARITY_SHAPES shapes
PARITY_BATCHES, PARITY_ROUNDS, PARITY_STEPS, PARITY_DVAE, PARITY_SHAPES = 2, 2, 2, 4, 2
# row -> (released file, protocol flags); the files are fabricated from seeds
PARITY_ROWS = {
    "scan_hardest": ("scan_hardest", {}),
    "scan_objbg": ("scan_objbg", {"vote": True}),
    "scan_objonly": ("scan_objonly", {}),
    "modelnet": ("modelnet", {}),
    "modelnet --from_pretrain --vote": ("pretrain", {"from_pretrain": True, "vote": True}),
    "fewshot_modelnet_5w10s": ("pretrain", {}),
    "fewshot_modelnet_5w20s": ("pretrain", {}),
    "fewshot_modelnet_10w10s": ("pretrain", {}),
    "fewshot_modelnet_10w20s": ("pretrain", {}),
    "s3dis": ("s3dis", {}),
    "dvae": ("dvae", {}),
}
# the kernels each kind of row must launch on the card (a S3DIS forward: FPS, the
# k=32 kNN and the k=3 3-NN, two gathers)
PARITY_KERNELS = {"cls": ("fps", "k_smallest", "gather"), "s3dis": ("fps", "k_smallest", "gather"),
                  "dvae": ("fps", "k_smallest", "gather", "chamfer_nn_min")}
# phase 46, in phase 42's child: the linear and mlp-3 variants of the 1k ModelNet and
# the three ScanObjectNN finetune configs and the two few-shot ones (at VARIANT_FEWSHOT:
# way, shot, fold), each at full width from its file for VARIANT_STEPS steps and a
# test batch
VARIANT_CONFIGS = tuple(f"cfgs/finetune_classification/{head}/finetune_{data}_{head}.yaml"
                        for data in ("modelnet", "scan_hardest", "scan_objbg", "scan_objonly")
                        for head in ("linear", "mlp3")) + tuple(
    f"cfgs/finetune_classification/few_shot/fewshot_modelnet_{head}.yaml"
    for head in ("linear", "mlp3"))
VARIANT_STEPS, VARIANT_FEWSHOT = 2, (5, 10, 0)
# phases 43-44: Point-BERT's plain DiscreteVAE (pointbert_dvae.yaml uncut: B=64, G=64 x
# M=32, 8192 codes, 384 wide, bf16; no teacher). 43 (``--plain-dvae``, a child alone on
# the card): its kernels at the path's shapes, phase 12's check (its upstream gradients
# PD_UPSTREAM_KEYS), run_autoencoder_steps from S1_START_ITR (the soft-Gumbel
# temperature and the KLD weight annealed), a step rerun, validate on PD_VAL_CLOUDS;
# 44 (``--plain-dvae-cli``, beside phase 37's tracing): main_autoencoder for
# PD_CLI_STEPS steps, resumed for as many, --test on PD_TEST_CLOUDS with PD_DUMPS
# dumps, and its ckpt-best served as tokenize and dvae at B=1 and PD_HTTP_B
PLAIN_DVAE_CONFIG = "cfgs/autoencoder/pointbert_dvae.yaml"
PD_UPSTREAM_KEYS = ("codebook", "dgcnn_1.layer5.0.weight", "encoder.first_conv.0.weight")
PD_VAL_CLOUDS, PD_CLI_STEPS, PD_TEST_CLOUDS, PD_DUMPS, PD_HTTP_B = 16, 2, 16, 2, 32
# phase 45 (``--flops``, beside phase 37's tracing): act_tpu_torch.get_flops on every
# shipped model YAML, on the card and on the CPU (FLOPS_CPU_THREADS threads)
FLOPS_DIRS = ("autoencoder", "pretrain", "finetune_classification/full",
              "finetune_classification/linear", "finetune_classification/mlp3")
FLOPS_CONFIGS, FLOPS_CPU_THREADS = 18, 4
# TPU kernels that a port kernel of another name covers: row -> (kernel, replaces)
COVERED = {"fps_start0": ("fps", "act_tpu/ops/fps.py:29")}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    """The card's name and power limit, as the port's measurements print them."""
    from act_tpu_torch.profiling import card_line as query
    return query()


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
    both clouds read, distances (and indices) written, the operations of
    ``ops/work.py``."""
    from act_tpu_torch.ops import work
    (B, N, _), M = x.shape, y.shape[1]
    out = (8 if index else 4) * B * (N + M)
    return bound_ms(12 * B * (N + M) + out, work.chamfer_nn(B, N, M))


def chamfer_bwd_bounds(x, y):
    """``bound_ms`` of one chamfer_bwd launch: x, y, the indices and the
    output gradients read, dx, dy written."""
    from act_tpu_torch.ops import work
    (B, N, _), M = x.shape, y.shape[1]
    return bound_ms(12 * B * (N + M) * 2 + 8 * B * (N + M), work.chamfer_bwd(B, N, M))


def distinct_rows(idx) -> int:
    """Rows of the table that a (B, S) gather reads: its distinct indices,
    counted per cloud."""
    s = idx.reshape(idx.shape[0], -1).sort(-1).values
    return int(s.shape[0] * (s.shape[1] > 0) + (s[:, 1:] != s[:, :-1]).sum().item())


def row_gather_bounds(grad, S, listing=True):
    """``bound_ms`` of one row_gather_bwd launch: the (B, M, C) gradient rows
    read once, the (B, S, C) sums written once, and the list of sources
    ((B, M) order and (B, S + 1) starts, int32) made from the (B, M) int32
    indices when ``listing`` (a launch at a fresh index), else read."""
    B, M, C = grad.shape
    csr = 4 * (B * M + B * (S + 1))
    return bound_ms(grad.element_size() * (B * M * C + B * S * C) + csr
                    + (4 * B * M if listing else 0))


def check_row_gather(tag, grad, idx, S, errs) -> None:
    """The row-gather backward kernel at one shape in f32 and bf16 against its
    plain version on the card, and against itself across two launches at one
    ``ops.row_index`` (the first lists the sources, the second reads the
    list): bit for bit (fails otherwise)."""
    import torch
    from act_tpu_torch import ops
    for dt in (torch.float32, torch.bfloat16):
        g, shared = grad.to(dt), ops.row_index(idx, S)
        got, again = ops.gather_rows_bwd(g, shared), ops.gather_rows_bwd(g, shared)
        want = ops.gather_rows_bwd_ref(g, idx, S)
        if not (torch.equal(got, want) and torch.equal(got, again)):
            fail(f"row_gather_bwd {tag} {dt}: not bit-equal to its plain version or to itself "
                 f"(max |diff| {float((got.float() - want.float()).abs().max())})")
        errs[f"row_gather_bwd {tag} {dt}"] = 0.0
    print(f"[check] row_gather_bwd {tag}: grad {tuple(grad.shape)} by {tuple(idx.shape)} into "
          f"{S} rows, f32 and bf16: bit-equal to its plain version and across two launches "
          f"(listing, then reading the list)",
          flush=True)


def rerun_bit_equal(model, optimizer, step):
    """Run ``step`` twice from one model and optimizer state; returns (whether
    every weight, buffer (BatchNorm statistics) and optimizer tensor (Adam's
    moments) came out bit-equal, the tensors compared)."""
    import copy

    import torch
    m0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    o0 = copy.deepcopy(optimizer.state_dict())
    outs = []
    for _ in range(2):
        model.load_state_dict(m0)
        optimizer.load_state_dict(copy.deepcopy(o0))
        step()
        torch.cuda.synchronize()
        outs.append([t.detach().clone() for t in model.state_dict().values()]
                    + [v.clone() for st in optimizer.state.values() for v in st.values()
                       if torch.is_tensor(v)])
    return (len(outs[0]) == len(outs[1])
            and all(torch.equal(a, b) for a, b in zip(*outs))), len(outs[0])


def timed(fn, iters, warm=3):
    """CUDA-event ms a call of ``fn``, over ``iters`` calls after ``warm``."""
    import torch
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


def measure(shape, fn, plain, library, iters, plain_iters, bound, n=1, plain_events=False):
    """Times of one launch shape; ``n`` launches of it a step or request.

    A kernel's time is its device time from torch.profiler (CUPTI): at these
    sizes a call's CUDA-event time is the host's dispatch time, which is
    printed beside it as "per call". A window whose records are not all
    there gives no device time (act_tpu_torch/profiling.py); the row then
    keeps the CUDA-event time and says so. ``plain_events`` times the plain
    version on CUDA events only (an FPS of 8191 steps launches ~65 000
    kernels, more than a profiler window should hold)."""
    from act_tpu_torch.profiling import device_ms
    call = timed(fn, iters)
    dev_ms = device_ms(fn, iters)
    return dict(shape=shape, n=n, ms=call if dev_ms is None else dev_ms, call_ms=call,
                timing="cuda_events" if dev_ms is None else "profiler",
                plain_ms=(timed(plain, plain_iters, 1) if plain_events else
                          device_ms(plain, plain_iters) or timed(plain, plain_iters, 1)),
                library_ms=None if library is None else
                (device_ms(library, iters) or timed(library, iters)),
                bound=bound)


def request_ms(fn, iters):
    """Host ms of ``iters`` calls of ``fn``, each ending in a device
    synchronize, after 3 warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def busy_line(kernel_events, tag, fn, med, iters=3, top_n=6):
    """Print the device busy time of a call of ``fn``, its idle share against
    the host median ``med`` and its top kernels; returns the busy ms (None
    when the profiler recorded nothing)."""
    ev = kernel_events(fn, iters)
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3 / iters
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    dev_txt = (f"device busy {busy:.3f} ms ({len(ev) // iters} kernels), idle share "
               f"{1 - busy / med:.3f}" if ev else "device busy not measured")
    print(f"[time] {tag}: {dev_txt}; top kernels (ms): "
          + "; ".join(f"{n[:60]} {t:.4f}" for n, t in top), flush=True)
    return busy if ev else None


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

def cut_depth(cfg):
    """``cfg`` with its transformers (the student, the teacher of a dVAE or a
    tokenizer) at ``CUT_DEPTH`` blocks (``CUT_DEPTH``'s note says where)."""
    m = cfg.model
    for node in (m, m.get("transformer_config"), m.get("dvae_config")):
        if node is not None:
            for key in ("depth", "visual_embed_depth"):
                if key in node:
                    node[key] = CUT_DEPTH
    return cfg


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
    from act_tpu_torch.ops import _backend, sampling, work
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
                bound_ms(logits.numel() * 2 + bs * G * 4, work.gumbel_argmax(bs * G, V)))],
            "fps": [measure(
                f"({bs}, {npts}, 3)->{G}", lambda: ops.furthest_point_sample(clouds, G),
                lambda: ops.furthest_point_sample_ref(clouds, G), None, 50, 3,
                bound_ms(clouds.numel() * 4 + bs * G * 4, work.fps(bs, npts, G)))],
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


def stage1_paths_agree(model, clouds, temp, kldw, dev, tag, upstream=UPSTREAM_KEYS) -> None:
    """Phase 12's check of a full-width Stage-I dVAE: one train-mode loss and
    backward through the kernels (launches checked) and one through the plain
    versions (patched into ``act_tpu_torch.ops`` and ``ops.chamfer``), from
    the same generators; the losses within LOSS_ATOL, the gradients of
    DOWNSTREAM_KEYS within GRAD_RTOL and those of ``upstream`` (the
    teacher's side) within SPREAD_FACTOR times the spread of two kernel-path
    runs, never below GRAD_RTOL."""
    import torch
    from act_tpu_torch import ops
    from act_tpu_torch.engine.train_state import step_rngs
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.ops import chamfer as chamfer_mod

    grad_keys = DOWNSTREAM_KEYS + tuple(upstream)

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
    check_launches(f"{tag}: dVAE loss and backward through the kernels",
                   dict(_backend.LAUNCHES), STAGE1_PER_STEP, 1)
    _, again = loss_and_grads()
    spread = {k: float((again[k] - grads_k[k]).norm() / grads_k[k].norm()) for k in grad_keys}
    _backend.reset_launches()
    with patched(ops, group_points=ops.group_points_ref,
                 graph_feature_idx=ops.graph_feature_idx_ref, gather_rows=ops.gather_rows_ref), \
            patched(chamfer_mod, nn_pair=ops.chamfer_ref, nn_pair_min=ops.chamfer_min_ref,
                    chamfer_bwd=ops.chamfer_bwd_ref):
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    if any(_backend.LAUNCHES.values()):
        fail(f"{tag}: the plain-version dVAE loss launched kernels: {_backend.LAUNCHES}")
    rel = {k: float((grads_k[k] - grads_p[k]).norm() / grads_p[k].norm()) for k in grad_keys}
    limit = {k: GRAD_RTOL if k in DOWNSTREAM_KEYS else max(GRAD_RTOL, SPREAD_FACTOR * spread[k])
             for k in grad_keys}
    print(f"[{tag}] train-mode loss through the kernels {loss_k}, through the plain versions "
          f"{loss_p}: |diff| {abs(loss_k - loss_p)} (tolerance {LOSS_ATOL}); gradients, "
          f"relative L2 difference: {rel}; two kernel-path runs differ by {spread}; "
          f"tolerance ({GRAD_RTOL} on the loss's side of the teacher, {SPREAD_FACTOR} x that "
          f"spread upstream of it): {limit}", flush=True)
    bad = [k for k in grad_keys if not rel[k] <= limit[k]]
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= LOSS_ATOL and not bad):
        fail(f"{tag}: Stage-I loss and backward: kernel path and plain path disagree ({bad})")
    model.zero_grad(set_to_none=True)


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
    from act_tpu_torch.ops import _backend, work
    from act_tpu_torch.ops import chamfer as chamfer_mod
    from act_tpu_torch.ops.fps import _sms, tie_swaps
    from act_tpu_torch.ops.reference import take_rows

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
        # the row-gather backward at the DGCNN's rounds: (B, G * 4) neighbour rows of G
        dg_idx = ops.graph_feature_idx(centers, centers, 4).reshape(bs, G * 4)
        dg_grads = {c: rnd(bs, G * 4, c) for c in sorted(set(DGCNN_ROUND_C))}
        for c, grad in dg_grads.items():
            check_row_gather(f"Stage-I DGCNN C={c}", grad, dg_idx, G, errs)

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
    stage1_paths_agree(model, clouds, temp, kldw, dev, "stage1")
    del model

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
    same, n_t = rerun_bit_equal(run.model, run.optimizer, lambda: step(steps + 2))
    print(f"[stage1] one Stage-I step (B={bs}, bf16) run twice from one state: every weight, "
          f"BN statistic and Adam moment bit-equal: {same} ({n_t} tensors)", flush=True)
    if not same:
        fail("Stage I: a step rerun from the same state differs")

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
    # dgcnn_1 with the row-gather kernel against torch.gather's own (atomic) backward, in turns
    dg_ms = {}
    for tag in ("torch.gather", "kernel", "kernel", "torch.gather"):
        with patched(ops, gather_rows=lambda t, ix: take_rows(t, ix.idx)) \
                if tag == "torch.gather" else patched(ops):
            dg_ms.setdefault(tag, []).append(
                round(timed(fwd_bwd(lambda f: m.dgcnn_1(f, ctr), feats), 20), 5))
    print(f"[time] Stage-I dgcnn_1 forward + backward (CUDA-event ms a call, in turns): with "
          f"the row-gather backward kernel {dg_ms['kernel']}, with torch.gather's atomic "
          f"backward (before the repair) {dg_ms['torch.gather']}", flush=True)

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
                bound_ms(clouds.numel() * 4 + bs * G * 4, work.fps(bs, npts, G)))],
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
        flat = (dg_idx.long() + G * torch.arange(bs, device=dev)[:, None]).reshape(-1)
        rows["row_gather_bwd"] = []
        # a step's launches: each DGCNN's first backward launch (round 4, C=512) lists
        # the sources, its other three (C=512, 256, 128) read the list
        listed = ops.row_index(dg_idx, G)
        ops.gather_rows_bwd(dg_grads[512].to(torch.bfloat16), listed)
        for c, n, fresh in ((512, 2, True), (512, 2, False), (256, 2, False), (128, 2, False)):
            gr = dg_grads[c].to(torch.bfloat16)
            base = torch.zeros(bs * G, c, dtype=gr.dtype, device=dev)
            rows["row_gather_bwd"].append(measure(
                f"{tuple(gr.shape)} bf16 by {tuple(dg_idx.shape)} into {G} rows (Stage-I DGCNN, "
                f"{'listing the sources' if fresh else 'reading the list'})",
                (lambda gr=gr: ops.gather_rows_bwd(gr, ops.row_index(dg_idx, G))) if fresh
                else (lambda gr=gr: ops.gather_rows_bwd(gr, listed)),
                lambda gr=gr: ops.gather_rows_bwd_ref(gr, dg_idx, G),
                lambda gr=gr, base=base: base.index_add(0, flat, gr.reshape(-1, gr.shape[-1])),
                100, 5, row_gather_bounds(gr, G, fresh), n))
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
    from act_tpu_torch.ops import _backend, work
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
                bound_ms(p.numel() * 4 + B_ * S * 4, work.fps(B_, N_, S)), n))
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
    from act_tpu_torch.ops import work
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
                         work.fps(p.shape[0], p.shape[1], S)))
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
                bound_ms(logits.numel() * 2 + G * 4, work.gumbel_argmax(G, V)), 0)],
        }
    print_times("chain ", rows)
    return rows, errs


def chain(dev):
    """Phases 20-24: the user's pipeline through the trainers' entry points
    at full width, the transformers at ``CUT_DEPTH`` blocks (``cut_depth``),
    every checkpoint under a temporary directory deleted afterwards. 20:
    Stage I, ``runner_autoencoder.run_net`` for one epoch of
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
        acfg = cut_depth(load_config(AUTOENCODER_CONFIG))
        res1 = counted("Stage-I run_net", lambda: runner_autoencoder.run_net(
            acfg, device=dev, epochs=1, max_steps=S1_RUN_STEPS,
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
            acfg, device=dev, epochs=2, max_steps=S1_RUN_STEPS,
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
            acfg, ckpts=best1, device=dev, experiment_path=s1,
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
        pcfg = cut_depth(load_config(PRETRAIN_CONFIG))
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
        fcfg = cut_depth(runner_finetune.finetune_config(CONFIG))
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


def segmentation(dev, device_ms, kernel_events, measure):
    """Phases 25-28, the segmentation path at full width (``SegBackbone`` 384
    x 12, G=128 groups of M=32, clouds of 2048 points, bf16): 25, FPS,
    k-smallest (k=32 and, for the 3-NN, k=3) and the gathers at the part-seg
    (B=16), sem-seg (B=32) and whole-scene (16 blocks) shapes against their
    plain versions, ``three_nn_interpolate`` against its plain path, and the
    kernel times; 26, the part-seg and sem-seg eval forwards through the
    kernels and through the plain versions, the request times, and
    ``serve_http`` with its 400 on a bad ``cls_label``; 27, one part-seg
    train-mode loss and backward through both, then ``run_partseg`` and
    ``run_semseg`` for a few steps and an evaluation each, ckpt-best
    reloaded, and the step times; 28, ``whole_scene_eval`` with the blocks
    batched against one block a forward. Returns (timing rows by kernel,
    errors, launches of each run of the path)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_seg_")
    try:
        return _segmentation(dev, device_ms, kernel_events, measure, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _segmentation(dev, device_ms, kernel_events, measure, tmp):
    import numpy as np
    import torch
    from act_tpu_torch import ops, serve_http
    from act_tpu_torch.datasets.segmentation_datasets import (PartNormalDataset,
                                                              S3DISDataset, WholeSceneDataset)
    from act_tpu_torch.engine import runner_segmentation as rs
    from act_tpu_torch.engine.serve import build_infer_fn, load_seg_model
    from act_tpu_torch.engine.train_state import seg_step, step_rngs
    from act_tpu_torch.models.segmentation import nll_seg_loss
    from act_tpu_torch.ops import _backend, work
    from act_tpu_torch.ops import interpolate as interp_mod
    from act_tpu_torch.ops.fps import tie_swaps
    from act_tpu_torch.ops.reference import take_rows

    N, G, M = SEG_NPOINT, SEG_GROUPS, SEG_GROUP_SIZE
    errs, launches = {}, {}
    none = os.path.join(tmp, "no_data")  # absent: the datasets' synthetic clouds
    part_ds = PartNormalDataset(none, N, split="trainval")
    part = [part_ds[i] for i in range(SEG_PART_B)]
    p_pts = torch.from_numpy(np.stack([x[0] for x in part])).to(dev)
    p_cls = np.asarray([x[1] for x in part])
    p_oh = torch.from_numpy(np.eye(16, dtype=np.float32)[p_cls]).to(dev)
    p_seg = torch.from_numpy(np.stack([x[2] for x in part])).to(dev)
    sem_ds = S3DISDataset("train", none, N)
    s_pts = torch.from_numpy(np.stack([sem_ds[i][0] for i in range(SEG_SEM_B)])).to(dev)
    blocks = [b for b, _, _ in WholeSceneDataset(none, N).blocks_for_scene(0)][:SEG_BLOCKS]
    w_pts = torch.from_numpy(np.stack(blocks)).to(dev)
    C = 3 * 384  # the three fetched hidden states of the 384-wide backbone

    def plain_path():
        return patched(ops, group_points=ops.group_points_ref,
                       three_nn_interpolate=ops.three_nn_interpolate_ref)

    # -- 25. the kernels at the segmentation shapes --------------------------------
    t_phase = time.perf_counter()
    shapes = {}
    swaps = {}
    with torch.inference_mode():
        for tag, pts in (("part seg", p_pts), ("sem seg", s_pts), ("whole scene", w_pts)):
            B = pts.shape[0]
            k, r = ops.furthest_point_sample(pts, G), ops.furthest_point_sample_ref(pts, G)
            n_sw = tie_swaps(k, r)
            if n_sw < 0 or not torch.equal(k.sort(-1).values, r.sort(-1).values):
                fail(f"fps {tag} ({B}, {N}, 3)->{G}: kernel picks differ beyond tie swaps")
            swaps[tag] = n_sw
            errs[f"fps seg {tag}"] = float(
                (ops.gather_points(pts, k) - ops.gather_points(pts, r)).abs().max())
            centers = ops.gather_points(pts, r)
            d32 = ops.square_distance(centers, pts).reshape(B * G, N)
            d3 = ops.square_distance(pts, centers).reshape(B * N, G)
            zeros = int((d3 == 0).sum())
            for d, kk in ((d32, M), (d3, 3)):
                (kv, ki), (rv, ri) = ops.k_smallest(d, kk), ops.k_smallest_ref(d, kk)
                if not (torch.equal(ki, ri) and torch.equal(kv.view(torch.int32),
                                                            rv.view(torch.int32))):
                    fail(f"k_smallest {tag} {tuple(d.shape)} k={kk}: differs from the plain "
                         "version")
                errs[f"k_smallest seg {tag} k={kk}"] = 0.0
            nbr = ops.k_smallest_ref(d32, M)[1].reshape(B, G * M)
            for p, i, what in ((pts, r, "centers"), (pts, nbr, "neighbourhoods")):
                if not torch.equal(ops.gather_coords(p, i).view(torch.int32),
                                   ops.gather_points(p, i).view(torch.int32)):
                    fail(f"gather {tag} {what} {tuple(p.shape)} by {tuple(i.shape)}: not "
                         "bit-equal")
                errs[f"gather seg {tag} {what}"] = 0.0
            feats = torch.randn(B, G, C, generator=torch.Generator(device=dev).manual_seed(B),
                                device=dev)
            if not torch.equal(ops.three_nn_interpolate(pts, centers, feats),
                               ops.three_nn_interpolate_ref(pts, centers, feats)):
                fail(f"three_nn_interpolate {tag}: differs from its plain version")
            print(f"[check] seg {tag} ({B}, {N}, 3): fps ->{G} equal up to {n_sw} adjacent tie "
                  f"swaps (same set); k_smallest {tuple(d32.shape)} k={M} and "
                  f"{tuple(d3.shape)} k=3 ({zeros} exact zeros) indices equal, values bit-equal; "
                  f"gathers by ({B}, {G}) and ({B}, {G * M}) bit-equal; three_nn_interpolate "
                  f"(C={C}) bit-equal to its plain version", flush=True)
            if tag == "whole scene":
                continue  # the part-seg shape again
            # the row-gather backward of the 3-NN blend: one of its three (B, N) gathers
            i3 = ops.k_smallest_ref(d3, 3)[1].reshape(B, N, 3)[:, :, 0].contiguous()
            g3 = torch.randn(B, N, C, generator=torch.Generator(device=dev).manual_seed(B + 1),
                             device=dev)
            check_row_gather(f"3-NN {tag}", g3, i3, G, errs)
            n = 1 if tag == "part seg" else 0  # launches a part-seg train step
            flat3 = (i3.long() + G * torch.arange(B, device=dev)[:, None]).reshape(-1)
            base3 = torch.zeros(B * G, C, device=dev)
            shapes.setdefault("row_gather_bwd", []).append(measure(
                f"{tuple(g3.shape)} f32 by {tuple(i3.shape)} into {G} rows ({tag} 3-NN)",
                lambda g3=g3, i3=i3: ops.gather_rows_bwd(g3, ops.row_index(i3, G)),
                lambda g3=g3, i3=i3: ops.gather_rows_bwd_ref(g3, i3, G),
                lambda g3=g3, f=flat3, b=base3: b.index_add(0, f, g3.reshape(-1, C)),
                50, 3, row_gather_bounds(g3, G), 3 * n))
            del g3
            rows = shapes.setdefault("fps", [])
            rows.append(measure(f"({B}, {N}, 3)->{G} ({tag})",
                                lambda p=pts: ops.furthest_point_sample(p, G),
                                lambda p=pts: ops.furthest_point_sample_ref(p, G), None, 20, 1,
                                bound_ms(pts.numel() * 4 + B * G * 4, work.fps(B, N, G)), n))
            for d, kk in ((d32, M), (d3, 3)):
                shapes.setdefault("k_smallest", []).append(measure(
                    f"({d.shape[0]}, {d.shape[1]}) k={kk} ({tag})",
                    lambda d=d, kk=kk: ops.k_smallest(d, kk),
                    lambda d=d, kk=kk: ops.k_smallest_ref(d, kk),
                    lambda d=d, kk=kk: torch.topk(d, kk, dim=-1, largest=False, sorted=True),
                    100, 10, bound_ms(d.numel() * 4 + d.shape[0] * kk * 8, d.numel()), n))
            for p, i, what in ((pts, r, "centers"), (pts, nbr, "neighbourhoods")):
                shapes.setdefault("gather", []).append(measure(
                    f"{tuple(p.shape)} by {tuple(i.shape)}, {distinct_rows(i)} rows read "
                    f"({tag} {what})",
                    lambda p=p, i=i: ops.gather_coords(p, i),
                    lambda p=p, i=i: ops.gather_points(p, i),
                    lambda p=p, li=i.long().reshape(B, -1, 1).expand(-1, -1, 3).contiguous():
                    torch.gather(p, 1, li), 200, 200,
                    bound_ms(distinct_rows(i) * 12 + i.numel() * 4 + i.numel() * 12), n))
            blend = (device_ms(lambda: ops.three_nn_interpolate(pts, centers, feats), 5),
                     device_ms(lambda: ops.three_nn_interpolate_ref(pts, centers, feats), 5))
            print(f"[time] seg three_nn_interpolate {tag} ({B}, {N}) from ({B}, {G}), C={C}, "
                  f"f32 (device ms): kernel path {blend[0]}, plain path {blend[1]}", flush=True)
    print_times("seg ", shapes)
    print(f"[seg] phase 25 {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 26. serving: the eval forwards through the kernels and the plain versions
    def hold_equal(tag, k, p, n_sw):
        """Bit-equal, or within SEG_LOGP_ATOL where an FPS tie swap was
        counted; neighbouring clouds must give different log-probs."""
        diff = float((k - p).abs().max())
        apart = float((k[1:] - k[:-1]).abs().flatten(1).amax(-1).min())
        print(f"[check] {tag} {tuple(k.shape)}: kernel path against plain path max |diff| "
              f"{diff} (tolerance: bit-equal, or {SEG_LOGP_ATOL} with FPS tie swaps; {n_sw} "
              f"counted); neighbouring clouds differ by at least {apart}", flush=True)
        if not apart > 0:
            fail(f"{tag}: two clouds give the same log-probs")
        if not (torch.equal(k, p) or (n_sw and diff <= SEG_LOGP_ATOL)):
            fail(f"{tag}: kernel path and plain path disagree")

    t_phase = t0 = time.perf_counter()
    models = {t: load_seg_model(t, seed=0, device=dev) for t in ("partseg", "semseg")}
    print(f"[model] seg partseg / semseg: "
          f"{[sum(p.numel() for p in m.parameters()) for m in models.values()]} params, bf16, "
          f"G={G}, M={M}, N={N}, built in {time.perf_counter() - t0:.2f} s", flush=True)
    infers = {t: build_infer_fn(m, N, with_fps=False) for t, m in models.items()}
    cases = (("partseg", (p_pts, p_oh), "part seg"), ("semseg", (w_pts,), "whole scene"))
    for task, inputs, tag in cases:
        infers[task](*(x[:2] for x in inputs))  # warm-up
        torch.cuda.synchronize()
        _backend.reset_launches()
        out_k = infers[task](*inputs)
        torch.cuda.synchronize()
        launches[f"serve {task} B={inputs[0].shape[0]}"] = got = dict(_backend.LAUNCHES)
        check_launches(f"serve {task}", got, SEG_PER_FORWARD, 1)
        with plain_path():
            _backend.reset_launches()
            out_p = infers[task](*inputs)
            if any(_backend.LAUNCHES.values()):
                fail(f"the plain-version {task} forward launched kernels: {_backend.LAUNCHES}")
        if tuple(out_k.shape) != (inputs[0].shape[0], N, models[task].cls_dim) or not bool(
                torch.isfinite(out_k).all()):
            fail(f"{task} log-probs: shape {tuple(out_k.shape)}, finite "
                 f"{bool(torch.isfinite(out_k).all())}")
        hold_equal(f"{task} eval log-probs", out_k, out_p, swaps[tag])

    for task, inputs, bs in (("partseg", (p_pts, p_oh), 1), ("partseg", (p_pts, p_oh), 16),
                             ("semseg", (w_pts,), 16)):
        x = tuple(t[:bs] for t in inputs)
        lat = request_ms(lambda: infers[task](*x), 20)
        med = statistics.median(lat)
        print(f"[time] seg request {task} B={bs} ({N} points each): median {med:.3f} ms, min "
              f"{min(lat):.3f}, max {max(lat):.3f} over 20; {bs / med * 1e3:.1f} clouds/s",
              flush=True)
        busy_line(kernel_events, f"seg request {task} B={bs}", lambda: infers[task](*x), med)

    for task, m in models.items():
        server = serve_http.make_server(infers[task], serve_http.seg_meta(m, task, N),
                                        "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/predict"
            pts = (p_pts if task == "partseg" else w_pts)[:SEG_HTTP_BATCH]
            body = {"points": pts.cpu().tolist(), "return_log_probs": True}
            bad = None
            if task == "partseg":
                body["cls_label"] = p_cls[:SEG_HTTP_BATCH].tolist()
                bad = {**body, "cls_label": [16] * SEG_HTTP_BATCH}

            def post(payload):
                req = urllib.request.Request(url, data=json.dumps(payload).encode())
                try:
                    with urllib.request.urlopen(req, timeout=120) as resp:
                        return resp.status, json.loads(resp.read())
                except urllib.error.HTTPError as e:
                    return e.code, json.loads(e.read())
            t0 = time.perf_counter()
            code, out = post(body)
            ms = (time.perf_counter() - t0) * 1e3
            want = infers[task](pts, *((p_oh[:SEG_HTTP_BATCH],) if task == "partseg" else ()))
            same = code == 200 and out["labels"] == want.argmax(-1).tolist() and torch.equal(
                torch.tensor(out["log_probs"], dtype=torch.float32), want.cpu())
            print(f"[http] seg {task}: {code}, labels and log-probs equal to the direct call "
                  f"{same}, {ms:.1f} ms with JSON", flush=True)
            if not same:
                fail(f"http {task}: status {code}, or the answer differs from the direct call")
            if bad is not None:
                code, out = post(bad)
                print(f"[http] seg {task} with cls_label ids of 16: {code} {out}", flush=True)
                if code != 400:
                    fail(f"http {task}: a cls_label id of 16 got {code}, not 400")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)

    print(f"[seg] phase 26 {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 27. training: one loss and backward through both paths, then the runners
    t_phase = time.perf_counter()
    st = rs.build_seg_state("partseg", 32, device=dev)
    model = st.model
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    gen = np.random.default_rng(0)
    a_pts = torch.from_numpy(rs._np_augment(gen, p_pts.cpu().numpy())).to(dev)
    with torch.no_grad():
        a_sw = tie_swaps(ops.furthest_point_sample(a_pts, G), ops.furthest_point_sample_ref(a_pts, G))
    if a_sw:
        fail(f"fps part-seg train batch: {a_sw} tie swaps; the comparison needs a batch without")

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        model.train()
        loss = nll_seg_loss(model(a_pts, p_oh, rngs=step_rngs(0, 0, dev)), p_seg)
        loss.backward()
        return loss.item(), {k: model.get_parameter(k).grad.float() for k in SEG_GRAD_KEYS}
    _backend.reset_launches()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    check_launches("part-seg loss and backward through the kernels", dict(_backend.LAUNCHES),
                   SEG_PER_STEP, 1)
    _, again = loss_and_grads()
    spread = {k: float((again[k] - grads_k[k]).norm() / grads_k[k].norm()) for k in SEG_GRAD_KEYS}
    with plain_path():
        _backend.reset_launches()
        loss_p, grads_p = loss_and_grads()
        torch.cuda.synchronize()
        if any(_backend.LAUNCHES.values()):
            fail(f"the plain-version part-seg loss launched kernels: {_backend.LAUNCHES}")
    rel = {k: float((grads_k[k] - grads_p[k]).norm() / grads_p[k].norm()) for k in SEG_GRAD_KEYS}
    limit = {k: max(GRAD_RTOL, SPREAD_FACTOR * spread[k]) for k in SEG_GRAD_KEYS}
    print(f"[seg] part-seg train-mode loss through the kernels {loss_k}, through the plain "
          f"versions {loss_p}: |diff| {abs(loss_k - loss_p)} (tolerance {LOSS_ATOL}); "
          f"gradients, relative L2 difference: {rel}; two kernel-path runs differ by {spread}; "
          f"tolerance ({SPREAD_FACTOR} x that spread, at least {GRAD_RTOL}): {limit}", flush=True)
    bad = [k for k in SEG_GRAD_KEYS if not rel[k] <= limit[k]]
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= LOSS_ATOL and not bad):
        fail(f"part-seg loss and backward: kernel path and plain path disagree ({bad})")
    model.zero_grad(set_to_none=True)
    model.load_state_dict({k: v.to(dev) for k, v in init.items()})

    for task, run in (("partseg", rs.run_partseg), ("semseg", rs.run_semseg)):
        exp = os.path.join(tmp, task)
        bs = SEG_PART_B if task == "partseg" else SEG_SEM_B
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _backend.reset_launches()
        t0 = time.perf_counter()
        res = run(root=none, npoint=N, batch_size=bs, epoch=1, experiment_path=exp, device=dev,
                  max_steps=SEG_RUN_STEPS, eval_batches=SEG_RUN_EVAL)
        run_s = time.perf_counter() - t0
        launches[f"run_{task}"] = got = dict(_backend.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check_launches(f"run_{task}", got, {k: SEG_RUN_STEPS * v + SEG_RUN_EVAL * SEG_PER_FORWARD.get(
            k, 0) for k, v in SEG_PER_STEP.items()}, 1)
        m = res.state.model
        seeded = load_seg_model(task, seed=0, device="cpu").state_dict()
        after = {k: v.detach().cpu() for k, v in m.state_dict().items()}
        trained = [n for n, p in m.named_parameters() if p.requires_grad]
        still = [n for n in trained if torch.equal(after[n], seeded[n])]
        bn_still = [k for k in after if "running" in k and torch.equal(after[k], seeded[k])]
        print(f"[seg] run_{task} ({SEG_RUN_STEPS} steps at B={bs}, {SEG_RUN_EVAL} evaluation "
              f"batches, {run_s:.1f} s): losses {res.losses}; metrics {res.epoch_metrics}; "
              f"launches {got}; trainable tensors moved {len(trained) - len(still)} of "
              f"{len(trained)}, BN statistics moved all but {len(bn_still)}; peak memory "
              f"{peak / 2 ** 30:.3f} GiB", flush=True)
        if not all(math.isfinite(x) for x in res.losses) or still or bn_still:
            fail(f"run_{task}: a loss is not finite, or tensors did not move "
                 f"({still + bn_still})")
        path = os.path.join(exp, "ckpt-best.pth")
        if not os.path.exists(path):
            fail(f"run_{task}: no ckpt-best (best {res.best})")
        x = (p_pts, p_oh) if task == "partseg" else (s_pts,)
        reloaded = build_infer_fn(load_seg_model(task, path, device=dev), N,
                                  with_fps=False)(*x)
        if not torch.equal(reloaded, build_infer_fn(m.eval(), N, with_fps=False)(*x)):
            fail(f"run_{task}: the reloaded ckpt-best gives other eval log-probs")
        print(f"[seg] run_{task} ckpt-best ({os.path.getsize(path) / 2 ** 20:.1f} MiB) reloaded: "
              "eval log-probs bit-equal to the trained model's", flush=True)
        # step times of the run's state: each step ends in a synchronize
        batch = (p_pts, p_seg, p_oh) if task == "partseg" else (s_pts, p_seg.new_zeros(
            bs, N).random_(0, 13), None)
        wt = torch.ones(13, device=dev) if task == "semseg" else None

        def step(i, st=res.state, b=batch, wt=wt):
            return seg_step(st.model, st.optimizer, st.schedule, b[0], b[1], i,
                            step_rngs(0, i, dev), b[2], wt)
        ms = request_ms(lambda: step(res.steps), SEG_TIMED_STEPS)
        med = statistics.median(ms)
        print(f"[time] seg {task} train step B={bs}: median {med:.3f} ms, min {min(ms):.3f}, "
              f"max {max(ms):.3f} over {SEG_TIMED_STEPS} (after 3 warm-up); "
              f"{bs / med * 1e3:.1f} clouds/s; peak memory {peak / 2 ** 30:.3f} GiB", flush=True)
        busy_line(kernel_events, f"seg {task} train step B={bs}", lambda: step(res.steps), med,
                  top_n=8)
        same, n_t = rerun_bit_equal(res.state.model, res.state.optimizer,
                                    lambda: step(res.steps))
        print(f"[seg] one {task} step (B={bs}, bf16) run twice from one state: every weight, BN "
              f"statistic and Adam moment bit-equal: {same} ({n_t} tensors)", flush=True)
        if not same:
            fail(f"seg {task}: a step rerun from the same state differs")
        if task == "partseg":  # the step's parts, device ms
            with torch.no_grad():
                ctr = ops.gather_coords(p_pts, ops.furthest_point_sample(p_pts, G))
            feats = torch.randn(bs, G, C, device=dev, requires_grad=True)
            grad_out = torch.randn(bs, N, C, device=dev)
            parts = {"group_points": device_ms(lambda: ops.group_points(p_pts, G, M), 3),
                     "three_nn_interpolate forward (C=1152)": device_ms(
                         lambda: ops.three_nn_interpolate(p_pts, ctr, feats), 3),
                     "three_nn_interpolate forward + backward": device_ms(
                         lambda: ops.three_nn_interpolate(p_pts, ctr, feats).backward(grad_out),
                         3),
                     "AdamW (clip and step)": device_ms(lambda: res.state.optimizer.step(), 3),
                     "whole step": device_ms(lambda: step(res.steps), 3)}
            print(f"[time] seg partseg train step B={bs} parts (device ms): " + ", ".join(
                f"{k} {v if v is None else round(v, 5)}" for k, v in parts.items()), flush=True)
            # the blend's forward + backward with the row-gather kernel against
            # torch.gather's own (atomic) backward, in turns
            blend_ms = {}
            for tag in ("torch.gather", "kernel", "kernel", "torch.gather"):
                with patched(interp_mod, gather_rows=take_rows) if tag == "torch.gather" \
                        else patched(interp_mod):
                    blend_ms.setdefault(tag, []).append(round(timed(
                        lambda: ops.three_nn_interpolate(p_pts, ctr, feats).backward(grad_out),
                        10), 5))
            print(f"[time] seg three_nn_interpolate forward + backward B={bs} (CUDA-event ms a "
                  f"call, in turns): with the row-gather backward kernel {blend_ms['kernel']}, "
                  f"with torch.gather's atomic backward (before the repair) "
                  f"{blend_ms['torch.gather']}", flush=True)
        if task == "semseg":
            trained_sem = m

    print(f"[seg] phase 27 {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 28. the whole-scene vote: blocks batched against one block a forward ----
    t_phase = time.perf_counter()
    votes, mets = {}, {}
    scenes = WholeSceneDataset(none, N)
    n_blocks = [sum(1 for _ in scenes.blocks_for_scene(s)) for s in range(len(scenes))]
    for bs in (SEG_BLOCKS, 1):
        _backend.reset_launches()
        t0 = time.perf_counter()
        mets[bs], votes[bs] = rs.whole_scene_eval(trained_sem, root=none, npoint=N,
                                                  eval_batch_size=bs, vote_num=1, device=dev)
        secs = time.perf_counter() - t0
        launches[f"whole_scene_eval eval_batch_size={bs}"] = got = dict(_backend.LAUNCHES)
        forwards = sum(-(-n // bs) for n in n_blocks)  # one forward a chunk of bs blocks
        check_launches(f"whole_scene_eval eval_batch_size={bs}", got, SEG_PER_FORWARD, forwards)
        print(f"[seg] whole_scene_eval eval_batch_size={bs}: {mets[bs]}; {forwards} forwards, "
              f"{secs:.2f} s", flush=True)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(votes[SEG_BLOCKS], votes[1]))
    flips = sum(int((a.argmax(-1) != b.argmax(-1)).sum()) for a, b in zip(votes[SEG_BLOCKS],
                                                                           votes[1]))
    print(f"[check] whole-scene votes, batched against one block a forward: max |diff| {diff} "
          f"(tolerance {SEG_VOTE_ATOL}), {flips} points change their vote", flush=True)
    if not diff <= SEG_VOTE_ATOL:
        fail("whole_scene_eval: the batched votes differ from the per-block votes")
    print(f"[seg] phase 28 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return shapes, errs, launches


def pointbert_config():
    """``pretrain_act_distill.yaml`` as ACT_PointBERT
    (``profile_step.pointbert_config``), with no Stage-I checkpoint: seeded
    weights."""
    from act_tpu_torch.profile_step import pointbert_config as config
    return config(PRETRAIN_CONFIG)


def pointbert(dev, device_ms, kernel_events, measure):
    """Phases 29-32, ACT_PointBERT at full width (``pointbert_config``): 29,
    ``forward_eval`` features at B=32 through the kernels and through the
    plain versions, a resampled request, ``serve_http``'s features kind with
    its 400, and the request times; 30, one train-mode forward and backward
    at B=128 through both paths with the same generators (token labels,
    losses, gradients); 31, ``run_steps`` with its step times and parts, the
    EMA of k held to its host recomputation and the queue pointer after each
    of a few more steps, and the kernel times at the step's shapes; 32,
    ``run_net`` through the ShapeNet-55 loader with the SVM probe, ckpt-last,
    and a resume that restores the weights and the queue. Returns (timing
    rows by kernel, errors, launches of each run of the path)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pb_")
    try:
        return _pointbert(dev, device_ms, kernel_events, measure, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _pointbert(dev, device_ms, kernel_events, measure, tmp):
    import numpy as np
    import torch
    from act_tpu_torch import ops, profile_step, serve_http
    from act_tpu_torch.datasets import build_dataset_from_cfg, synthetic_batch
    from act_tpu_torch.engine import checkpoint as ckpt_lib
    from act_tpu_torch.engine import runner_pretrain as rp
    from act_tpu_torch.engine.serve import build_features_fn
    from act_tpu_torch.engine.train_state import ema_update, pretrain_step, step_rngs
    from act_tpu_torch.ops import _backend, work
    from act_tpu_torch.ops.fps import tie_swaps

    cfg = pointbert_config()
    mc = cfg.model
    bs, npts = int(cfg.total_bs), int(cfg.dataset.train.others.npoints)
    G, M, K = int(mc.dvae_config.num_group), int(mc.dvae_config.group_size), int(mc.K)
    m = float(mc.m)
    errs, launches = {}, {}
    clouds = torch.from_numpy(synthetic_batch(0, bs, npts)).to(dev)

    def plain_path():
        return patched(ops, group_points=ops.group_points_ref,
                       graph_feature_idx=ops.graph_feature_idx_ref)

    def counted(tag, fn, plain=False):
        torch.cuda.synchronize()
        _backend.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[tag] = dict(_backend.LAUNCHES)
        if plain and any(launches[tag].values()):
            fail(f"pointbert {tag}: the plain path launched kernels: {launches[tag]}")
        return out

    def swaps_of(pts):
        with torch.no_grad():
            return tie_swaps(ops.furthest_point_sample(pts, G),
                             ops.furthest_point_sample_ref(pts, G))

    # -- 29. serving: forward_eval features through the kernels and the plain path
    t_phase = t0 = time.perf_counter()
    model = rp.freeze_tokenizer(rp.build_pretrain_model(mc, seed=0), cfg).to(dev).eval()
    n_all = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"[model] ACT_PointBERT ({PRETRAIN_CONFIG} with {profile_step.POINTBERT_MODEL}, "
          f"{profile_step.POINTBERT_TC}): "
          f"{n_all} params ({n_train} trainable: transformer_q), queue "
          f"{tuple(model.queue.shape)}, built in {time.perf_counter() - t0:.2f} s", flush=True)
    features = build_features_fn(model, npts)
    x = clouds[:PB_FEAT_B]
    features(x[:2])  # warm-up
    tag = f"features B={PB_FEAT_B}"
    feat_k = counted(tag, lambda: features(x))
    check_launches(f"pointbert {tag}", launches[tag], FEATURES_PER_REQUEST, 1)
    with plain_path():
        feat_p = counted(f"{tag}, plain", lambda: features(x), plain=True)
    cls_dim = int(mc.transformer_config.cls_dim)
    if tuple(feat_k.shape) != (PB_FEAT_B, cls_dim) or not bool(torch.isfinite(feat_k).all()):
        fail(f"pointbert features: shape {tuple(feat_k.shape)} or not finite")
    n_sw = swaps_of(x)
    diff = float((feat_k - feat_p).abs().max())
    apart = float((feat_k[1:] - feat_k[:-1]).abs().amax(-1).min())
    tol = 0.0 if n_sw == 0 else FEAT_ATOL
    errs["pointbert features"] = diff
    print(f"[pointbert] features {tuple(feat_k.shape)} through the kernels against the plain "
          f"path: max |diff| {diff} (tolerance {tol}: {n_sw} FPS tie swaps); neighbouring "
          f"clouds at least {apart} apart; launches {launches[tag]}", flush=True)
    if not (diff <= tol and apart > 0):
        fail("pointbert features: kernel path and plain path disagree")
    big = torch.from_numpy(synthetic_batch(1, 4, PB_HTTP_N)).to(dev)
    counted("features resampled", lambda: features(big))
    check_launches("pointbert features resampled", launches["features resampled"],
                   FEATURES_RESAMPLED, 1)
    meta = {"kind": "features", "model": "ACT_PointBERT", "npoints": npts, "cls_dim": cls_dim}
    server = serve_http.make_server(features, meta, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/predict"

        def post(payload):
            req = urllib.request.Request(url, data=json.dumps(payload).encode())
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())
        for r in range(HTTP_REQUESTS):
            batch = big[r:r + 2]
            t0 = time.perf_counter()
            code, out = post({"points": batch.cpu().tolist()})
            ms = (time.perf_counter() - t0) * 1e3
            same = code == 200 and torch.equal(
                torch.tensor(out["features"], dtype=torch.float32), features(batch).cpu())
            print(f"[http] pointbert features request {r} ({tuple(batch.shape)}, resampled to "
                  f"{npts}): {code}, equal to the direct call {same}, {ms:.1f} ms with JSON",
                  flush=True)
            if not same:
                fail(f"http pointbert features request {r}: status {code} or another answer")
        bad = big[:1].cpu().clone()
        bad[0, 3, 0] = float("nan")
        code, out = post({"points": bad.tolist()})
        print(f"[http] pointbert features with a NaN coordinate: {code} {out}", flush=True)
        if code != 400:
            fail(f"http pointbert features: a NaN coordinate got {code}, not 400")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    for b in (1, PB_FEAT_B):
        lat = request_ms(lambda b=b: features(clouds[:b]), 20)
        med = statistics.median(lat)
        print(f"[time] pointbert features request B={b} ({npts} points each): median "
              f"{med:.3f} ms, min {min(lat):.3f}, max {max(lat):.3f} over 20; "
              f"{b / med * 1e3:.1f} clouds/s", flush=True)
        busy_line(kernel_events, f"pointbert features request B={b}",
                  lambda b=b: features(clouds[:b]), med)
    print(f"[pointbert] phase 29 {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 30. one train-mode loss and backward through both paths -------------------
    t_phase = time.perf_counter()
    n_sw = swaps_of(clouds)
    if n_sw:
        fail(f"fps pointbert train batch: {n_sw} tie swaps; the comparison needs a batch "
             "without them")
    queue0 = {k: v.clone() for k, v in model.named_buffers() if k.startswith("queue")}
    labels = {}

    def loss_and_grads(tag):
        with torch.no_grad():
            for k, v in queue0.items():
                model.get_buffer(k).copy_(v)
        model.zero_grad(set_to_none=True)
        model.train()
        tokenize = model.dvae.forward_tokenizer

        def record(nbr, ctr):
            labels[tag] = tokenize(nbr, ctr)
            return labels[tag]
        with patched(model.dvae, forward_tokenizer=record):
            losses = model(clouds, rngs=step_rngs(0, 0, dev))
        sum(losses).backward()
        return ([float(v.detach()) for v in losses],
                {k: model.get_parameter(k).grad.float().clone() for k in PB_GRAD_KEYS})
    losses_k, grads_k = counted("train loss and backward", lambda: loss_and_grads("kernel"))
    check_launches("pointbert train loss and backward", launches["train loss and backward"],
                   POINTBERT_PER_STEP, 1)
    _, again = loss_and_grads("again")
    with plain_path():
        losses_p, grads_p = counted("train loss and backward, plain",
                                    lambda: loss_and_grads("plain"), plain=True)
    same_labels = torch.equal(labels["kernel"], labels["plain"])
    spread = {k: float((again[k] - grads_k[k]).norm() / grads_k[k].norm()) for k in PB_GRAD_KEYS}
    rel = {k: float((grads_k[k] - grads_p[k]).norm() / grads_p[k].norm()) for k in PB_GRAD_KEYS}
    limit = {k: max(GRAD_RTOL, SPREAD_FACTOR * spread[k]) for k in PB_GRAD_KEYS}
    dl = max(abs(a - b) for a, b in zip(losses_k, losses_p))
    errs["pointbert train losses"] = dl
    print(f"[pointbert] train-mode (moco, dvae, cutmix) losses through the kernels {losses_k}, "
          f"through the plain versions {losses_p}: max |diff| {dl} (tolerance {LOSS_ATOL}); "
          f"token labels {tuple(labels['kernel'].shape)} equal {same_labels}; gradients, "
          f"relative L2 difference: {rel}; two kernel-path runs differ by {spread}; tolerance "
          f"({SPREAD_FACTOR} x that spread, at least {GRAD_RTOL}): {limit}", flush=True)
    bad = [k for k in PB_GRAD_KEYS if not rel[k] <= limit[k]]
    if not (all(map(math.isfinite, losses_k)) and dl <= LOSS_ATOL and same_labels and not bad):
        fail(f"pointbert loss and backward: kernel path and plain path disagree ({bad})")
    del model, features, grads_k, grads_p, again
    torch.cuda.empty_cache()
    print(f"[pointbert] phase 30 {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 31. run_steps, the EMA and the queue after each step, the step's parts -----
    t_phase = time.perf_counter()
    steps = WARM_STEPS + TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = counted("run_steps", lambda: rp.run_steps(cfg, steps, seed=0, device=dev))
    peak = torch.cuda.max_memory_allocated()
    check_launches("pointbert run_steps", launches["run_steps"], POINTBERT_PER_STEP, steps)
    model = run.model
    fresh = rp.build_pretrain_model(mc, seed=0).state_dict()
    after = model.state_dict()
    dvae_same = all(torch.equal(v.cpu(), fresh[k].to(v.dtype)) for k, v in after.items()
                    if k.startswith("dvae.") and "running" not in k and "num_batches" not in k)
    moved = {k: not torch.equal(after[k].cpu(), fresh[k]) for k in
             ("transformer_q.lm_head.weight", "transformer_k.lm_head.weight",
              "transformer_q.blocks.blocks.0.attn.qkv.weight")}
    ptr = int(model.queue_ptr)
    print(f"[pointbert] run_steps losses {run.losses}; launches {launches['run_steps']}; dvae "
          f"parameters bit-equal to the seeded ones in bf16: {dvae_same}; moved {moved}; queue "
          f"pointer {ptr} (expected {steps * bs % K})", flush=True)
    if not (all(map(math.isfinite, run.losses)) and dvae_same and all(moved.values())
            and ptr == steps * bs % K):
        fail("pointbert run_steps: a loss, the frozen tokenizer, a moved tensor or the queue "
             "pointer is wrong")
    k_mod, q_mod = model.transformer_k, model.transformer_q
    worst = 0.0
    for i in range(PB_EMA_STEPS):
        k_old = {n: p.detach().cpu().clone() for n, p in k_mod.named_parameters()}
        ptr_old = int(model.queue_ptr)
        pretrain_step(model, run.optimizer, lambda s: 1e-3, clouds, steps + i,
                      step_rngs(0, steps + i, dev), ema_momentum=m)
        q_new = {n: p.detach().cpu() for n, p in q_mod.named_parameters()}
        for n, p in k_mod.named_parameters():
            host = k_old[n] * m + q_new[n] * (1.0 - m)
            ulps = ((p.detach().cpu() - host).abs() / torch.from_numpy(
                np.spacing(host.abs().numpy()))).max()
            worst = max(worst, float(ulps))
        if int(model.queue_ptr) != (ptr_old + bs) % K:
            fail(f"pointbert step {steps + i}: queue pointer {int(model.queue_ptr)}, expected "
                 f"{(ptr_old + bs) % K}")
    errs["pointbert ema"] = worst
    print(f"[pointbert] EMA of transformer_k after each of {PB_EMA_STEPS} steps (lr 1e-3) "
          f"against k * m + q * (1 - m) on the host: at most {worst} f32 ulp (tolerance 1); "
          f"queue pointer advanced by {bs} mod {K} each step", flush=True)
    if not worst <= 1.0:
        fail("pointbert EMA: transformer_k differs from its host recomputation")
    med = statistics.median(run.step_ms[WARM_STEPS:])
    print(f"[time] PointBERT step B={bs}: median {med:.3f} ms, min {min(run.step_ms):.3f}, max "
          f"{max(run.step_ms[WARM_STEPS:]):.3f} over {TIMED_STEPS} (after {WARM_STEPS} warm-up); "
          f"{bs / med * 1e3:.1f} clouds/s; peak memory {peak / 2 ** 30:.3f} GiB", flush=True)

    def step(i):
        return pretrain_step(model, run.optimizer, lambda s: 1e-6, clouds, i,
                             step_rngs(0, i, dev), ema_momentum=m)
    busy_line(kernel_events, f"PointBERT step B={bs}", lambda: step(steps), med, top_n=8)
    tok = model.dvae
    with torch.no_grad():
        nbr, ctr = ops.group_points(clouds, G, M)
        model.train()
        feats = tok.encoder(nbr)
    h = torch.randn(bs, G, int(mc.transformer_config.embed_dim), device=dev, requires_grad=True)
    g_logits = torch.randn(bs, G, int(mc.dvae_config.num_tokens), device=dev)

    def q_pass():
        cls, logits, _ = q_mod(nbr, ctr, step_rngs(0, 0, dev))
        (cls.sum() + logits.sum()).backward()

    def no_grad(fn):
        def call():
            with torch.no_grad():
                return fn()
        return call
    parts = {
        "group_points": device_ms(lambda: ops.group_points(clouds, G, M), 3),
        "tokenizer labels (train mode, no grad)": device_ms(
            no_grad(lambda: tok.forward_tokenizer(nbr, ctr)), 3),
        "  of which encoder": device_ms(no_grad(lambda: tok.encoder(nbr)), 3),
        "  dgcnn_1": device_ms(no_grad(lambda: tok.dgcnn_1(feats, ctr)), 3),
        "transformer_q pass forward + backward": device_ms(q_pass, 3),
        "  of which group encoder forward + backward": device_ms(
            lambda: q_mod.encoder(nbr).float().sum().backward(), 3),
        "  lm_head forward + backward (f32)": device_ms(
            lambda: q_mod.lm_head(h).backward(g_logits), 3),
        "transformer_k forward (no grad)": device_ms(
            no_grad(lambda: model.transformer_k(nbr, ctr, step_rngs(0, 0, dev),
                                                only_cls_tokens=True)), 3),
        "AdamW": device_ms(lambda: run.optimizer.step(), 3),
        "EMA": device_ms(lambda: ema_update(k_mod, q_mod, m), 3),
        "whole step": device_ms(lambda: step(steps + 1), 3)}
    print(f"[time] PointBERT step parts (device ms): " + ", ".join(
        f"{k} {v if v is None else round(v, 5)}" for k, v in parts.items()), flush=True)
    with torch.inference_mode():
        centers = ops.gather_points(clouds, ops.furthest_point_sample_ref(clouds, G))
        d_grp = ops.square_distance(centers, clouds).reshape(bs * G, npts)
        d_dg = ops.square_distance(centers, centers).reshape(bs * G, G)
        rc = ops.furthest_point_sample_ref(clouds, G)
        gathers = [(clouds, rc), (clouds, ops.k_smallest_ref(d_grp, M)[1].reshape(bs, G * M))]
        rows = {
            "fps": [measure(
                f"({bs}, {npts}, 3)->{G} (pointbert)",
                lambda: ops.furthest_point_sample(clouds, G),
                lambda: ops.furthest_point_sample_ref(clouds, G), None, 50, 3,
                bound_ms(clouds.numel() * 4 + bs * G * 4, work.fps(bs, npts, G)))],
            "k_smallest": [measure(
                f"({d.shape[0]}, {d.shape[1]}) k={kk} (pointbert)",
                lambda d=d, kk=kk: ops.k_smallest(d, kk),
                lambda d=d, kk=kk: ops.k_smallest_ref(d, kk),
                lambda d=d, kk=kk: torch.topk(d, kk, dim=-1, largest=False, sorted=True),
                100, 20, bound_ms(d.numel() * 4 + d.shape[0] * kk * 8, d.numel()))
                for d, kk in ((d_grp, M), (d_dg, 4))],
            "gather": [measure(
                f"{tuple(p.shape)} by {tuple(i.shape)}, {distinct_rows(i)} rows read (pointbert)",
                lambda p=p, i=i: ops.gather_coords(p, i), lambda p=p, i=i: ops.gather_points(p, i),
                lambda p=p, li=i.long().reshape(bs, -1, 1).expand(-1, -1, 3).contiguous():
                torch.gather(p, 1, li), 200, 200,
                bound_ms(distinct_rows(i) * 12 + i.numel() * 4 + i.numel() * 12))
                for p, i in gathers],
        }
    print_times("pointbert ", rows)
    del model, run, tok, feats, nbr, h, g_logits, k_mod, q_mod
    torch.cuda.empty_cache()
    print(f"[pointbert] phase 31 {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 32. run_net through the loader with the SVM probe, ckpt-last and --resume ---
    t_phase = time.perf_counter()
    exp = os.path.join(tmp, "pointbert")

    def run_cfg():
        return cut_depth(pointbert_config())
    res = counted("run_net", lambda: rp.run_net(run_cfg(), device=dev, epochs=1,
                                               max_steps=PB_RUN_STEPS, experiment_path=exp))
    # the probe's batches: the train split drops its last partial batch
    n_probe = sum((len(build_dataset_from_cfg(cfg.dataset[n])) + pad) // PROBE_BATCH
                  for n, pad in (("extra_train", 0), ("val", PROBE_BATCH - 1)))
    want = {k: POINTBERT_PER_STEP.get(k, 0) * PB_RUN_STEPS + PROBE_PER_BATCH.get(k, 0) * n_probe
            for k in launches["run_net"]}
    check_launches("pointbert run_net", launches["run_net"], want, 1)
    probe = res.probes[0]
    last = ckpt_lib.ckpt_path(exp, "ckpt-last")
    print(f"[pointbert] run_net: {res.step} steps, loss {res.epoch_loss}; SVM probe accuracy "
          f"{probe.acc:.4f} % ({n_probe} batches of {PROBE_BATCH}), relative gradient norm "
          f"{probe.svm_rel_grad:.3e}; ckpt-last {os.path.getsize(last) / 2 ** 20:.1f} MiB; "
          f"launches {launches['run_net']}", flush=True)
    if not (res.step == PB_RUN_STEPS and all(map(math.isfinite, res.epoch_loss))
            and math.isfinite(probe.acc) and probe.svm_rel_grad <= 1e-6):
        fail("pointbert run_net: steps, loss or probe wrong")
    again = counted("run_net resume", lambda: rp.run_net(run_cfg(), device=dev,
                                                        epochs=1, resume=True,
                                                        experiment_path=exp))
    want_sd, got_sd = res.model.state_dict(), again.model.state_dict()
    same = sorted(want_sd) == sorted(got_sd) and all(torch.equal(got_sd[k], v)
                                                     for k, v in want_sd.items())
    print(f"[pointbert] resume of ckpt-last: step {again.step}, no epoch left to run; "
          f"{len(got_sd)} tensors with the queue {tuple(got_sd['queue'].shape)} and its pointer "
          f"{int(got_sd['queue_ptr'])} bit-equal to the trained model's: {same}; phase 32 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if not (same and again.step == PB_RUN_STEPS and int(got_sd["queue_ptr"]) ==
            PB_RUN_STEPS * bs % K and not any(launches["run_net resume"].values())):
        fail("pointbert resume: the weights, the queue or the step were not restored")
    del res, again
    torch.cuda.empty_cache()
    return rows, errs, launches


def teacher_config(arch):
    """``act_dvae_with_pretrained_transformer.yaml`` with the teacher of
    ``arch`` (``TEACHER_ARCHS``): CLIP ViT-B/16's visual transformer or
    bert-base, 768 x 12, 12 heads, the 64 deep prompts, B=64, bf16."""
    from act_tpu_torch.engine.serve import load_config
    cfg = load_config(AUTOENCODER_CONFIG)
    cfg.model.update(TEACHER_ARCHS[arch])
    return cfg


def tokenizer(dev, device_ms, kernel_events, measure):
    """Phases 33-35, the dVAE tokenizer served and its CLIP and BERT teachers:
    33, ``build_tokenize_fn`` and ``build_recon_fn`` of the full-width Stage-I
    config (the ViT-B teacher, G=64 x M=32, 8192 tokens, bf16, seeded
    weights) at B=1 and B=32 through the kernels and through the plain
    versions, ``serve_http``'s tokenize and dvae kinds with a 400, the request
    times and the kernel times at its shapes; 34, for each of the CLIP and
    BERT teachers (``teacher_config``) phase 12's loss and backward check and
    ``run_autoencoder_steps`` with the frozen backbone held bit for bit; 35,
    Stage II (``pretrain_act_distill.yaml``, B=128) with the CLIP tokenizer
    handed over from phase 34's ``.pth``: its features through the kernels
    against the plain path, then ``run_steps``. Returns (timing rows by
    kernel, errors, launches of each run)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tk_")
    try:
        return _tokenizer(dev, device_ms, kernel_events, measure, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _tokenizer(dev, device_ms, kernel_events, measure, tmp):
    import torch
    from act_tpu_torch import ops, serve_http
    from act_tpu_torch.datasets import synthetic_batch
    from act_tpu_torch.engine import runner_pretrain as rp
    from act_tpu_torch.engine.runner_autoencoder import (get_kld_weight, get_temp,
                                                         prepare_model, run_autoencoder_steps)
    from act_tpu_torch.engine.serve import (build_recon_fn, build_tokenize_fn, load_config,
                                            load_model)
    from act_tpu_torch.engine.train_state import autoencoder_step, pretrain_step, step_rngs
    from act_tpu_torch.models.teacher import TEACHER_LAYOUT
    from act_tpu_torch.ops import _backend, work
    from act_tpu_torch.ops.fps import tie_swaps

    cfg = load_config(AUTOENCODER_CONFIG)
    npts, G, M = int(cfg.npoints), int(cfg.model.num_group), int(cfg.model.group_size)
    errs, launches = {}, {}
    clouds = torch.from_numpy(synthetic_batch(0, TOK_B, npts)).to(dev)

    def plain_path():
        return patched(ops, group_points=ops.group_points_ref,
                       graph_feature_idx=ops.graph_feature_idx_ref)

    def counted(tag, fn, plain=False):
        torch.cuda.synchronize()
        _backend.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[tag] = dict(_backend.LAUNCHES)
        if plain and any(launches[tag].values()):
            fail(f"tokenizer {tag}: the plain path launched kernels: {launches[tag]}")
        return out

    # -- 33. serving: tokens and reconstructions through the kernels and the plain path
    t_phase = t0 = time.perf_counter()
    model = load_model(cfg, seed=0, device=dev)
    fns = {"tokenize": build_tokenize_fn(model, npts), "dvae": build_recon_fn(model, npts)}
    per_request = {"tokenize": TOKENIZE_PER_REQUEST, "dvae": RECON_PER_REQUEST}
    print(f"[model] {AUTOENCODER_CONFIG} served: {sum(p.numel() for p in model.parameters())} "
          f"params, dtype bf16, built in {time.perf_counter() - t0:.2f} s", flush=True)
    for kind, fn in fns.items():
        fn(clouds[:2])  # warm-up
        for b in (1, TOK_B):
            x = clouds[:b]
            tag = f"{kind} B={b}"
            got = counted(tag, lambda: fn(x))
            check_launches(f"tokenizer {tag}", launches[tag], per_request[kind], 1)
            with plain_path():
                want = counted(f"{tag}, plain", lambda: fn(x), plain=True)
            with torch.no_grad():
                n_sw = tie_swaps(ops.furthest_point_sample(x, G),
                                 ops.furthest_point_sample_ref(x, G))
            shape = (b, G) if kind == "tokenize" else (b, G * M, 3)
            if tuple(got.shape) != shape or (kind == "dvae" and not torch.isfinite(got).all()):
                fail(f"tokenizer {tag}: shape {tuple(got.shape)} (expected {shape}) or not finite")
            if n_sw == 0:  # same groups in the same order: exact
                same = torch.equal(got, want)
            elif kind == "tokenize":  # a swap reorders two groups' ids
                same = torch.equal(got.sort(-1).values, want.sort(-1).values)
            else:
                same = torch.equal(got.reshape(b, G, M, 3).sort(1).values,
                                   want.reshape(b, G, M, 3).sort(1).values)
            errs[f"tokenizer {tag}"] = 0.0 if kind == "tokenize" else float(
                (got - want).abs().max())
            codes = (f"{int(torch.unique(got).numel())} distinct codes; "
                     if kind == "tokenize" else "")
            print(f"[tokenizer] {tag} {tuple(got.shape)} {got.dtype} through the kernels "
                  f"against the plain path: {'equal' if same else 'DIFFERENT'} (tolerance: "
                  f"exact; {n_sw} FPS tie swaps); {codes}launches {launches[tag]}", flush=True)
            if not same:
                fail(f"tokenizer {tag}: kernel path and plain path disagree")
        if not torch.equal(fn(clouds), fn(clouds)):
            fail(f"tokenizer {kind}: two calls on the same clouds disagree")
    for kind, fn in fns.items():
        meta = {"kind": kind, "model": cfg.model.NAME, "npoints": npts, "num_group": G,
                "group_size": M, "device": str(dev)}
        server = serve_http.make_server(fn, meta, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/predict"

            def post(payload):
                req = urllib.request.Request(url, data=json.dumps(payload).encode())
                try:
                    with urllib.request.urlopen(req, timeout=120) as resp:
                        return resp.status, json.loads(resp.read())
                except urllib.error.HTTPError as e:
                    return e.code, json.loads(e.read())
            batch = clouds[:TOK_HTTP_B]
            t0 = time.perf_counter()
            code, out = post({"points": batch.cpu().tolist()})
            ms = (time.perf_counter() - t0) * 1e3
            key = "tokens" if kind == "tokenize" else "recon"
            direct = fn(batch).cpu()
            same = code == 200 and torch.equal(torch.tensor(out[key], dtype=direct.dtype), direct)
            code_bad, out_bad = post({"points": batch[:, :npts - 24].cpu().tolist()})
            print(f"[http] {kind} request {tuple(batch.shape)}: {code}, equal to the direct call "
                  f"{same}, {ms:.1f} ms with JSON; {npts - 24} points a cloud: {code_bad} "
                  f"{out_bad}", flush=True)
            if not same or code_bad != 400:
                fail(f"http {kind}: status {code}, another answer, or {code_bad} for a wrong "
                     "point count")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    print(f"[time] card: {card_line()}", flush=True)
    for kind, fn in fns.items():
        for b in (1, TOK_B):
            lat = request_ms(lambda b=b: fn(clouds[:b]), 20)
            med = statistics.median(lat)
            print(f"[time] {kind} request B={b} ({npts} points each): median {med:.3f} ms, "
                  f"min {min(lat):.3f}, max {max(lat):.3f} over 20; {b / med * 1e3:.1f} "
                  f"clouds/s", flush=True)
            busy_line(kernel_events, f"{kind} request B={b}", lambda b=b: fn(clouds[:b]), med)
    with torch.inference_mode():
        rc = ops.furthest_point_sample_ref(clouds, G)
        centers = ops.gather_points(clouds, rc)
        d_grp = ops.square_distance(centers, clouds).reshape(TOK_B * G, npts)
        d_dg = ops.square_distance(centers, centers).reshape(TOK_B * G, G)
        gathers = [(clouds, rc),
                   (clouds, ops.k_smallest_ref(d_grp, M)[1].reshape(TOK_B, G * M))]
        rows = {
            "fps": [measure(
                f"({TOK_B}, {npts}, 3)->{G} (tokenize, recon)",
                lambda: ops.furthest_point_sample(clouds, G),
                lambda: ops.furthest_point_sample_ref(clouds, G), None, 50, 3,
                bound_ms(clouds.numel() * 4 + TOK_B * G * 4, work.fps(TOK_B, npts, G)))],
            "k_smallest": [measure(
                f"({d.shape[0]}, {d.shape[1]}) k={kk} (tokenize x{n}, recon x{n + r})",
                lambda d=d, kk=kk: ops.k_smallest(d, kk),
                lambda d=d, kk=kk: ops.k_smallest_ref(d, kk),
                lambda d=d, kk=kk: torch.topk(d, kk, dim=-1, largest=False, sorted=True),
                100, 20, bound_ms(d.numel() * 4 + d.shape[0] * kk * 8, d.numel()), n)
                for (d, kk), n, r in (((d_grp, M), 1, 0), ((d_dg, 4), 1, 1))],
            "gather": [measure(
                f"{tuple(p.shape)} by {tuple(i.shape)}, {distinct_rows(i)} rows read "
                "(tokenize, recon)",
                lambda p=p, i=i: ops.gather_coords(p, i), lambda p=p, i=i: ops.gather_points(p, i),
                lambda p=p, li=i.long().reshape(TOK_B, -1, 1).expand(-1, -1, 3).contiguous():
                torch.gather(p, 1, li), 200, 200,
                bound_ms(distinct_rows(i) * 12 + i.numel() * 4 + i.numel() * 12))
                for p, i in gathers],
        }
    print_times("tokenizer B=32 ", rows)
    del model, fns
    torch.cuda.empty_cache()
    print(f"[tokenizer] phase 33 {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 34. Stage I with the CLIP and the BERT teacher -----------------------------
    temp, kldw = get_temp(cfg, S1_START_ITR), get_kld_weight(cfg, S1_START_ITR)
    s1_clouds = torch.from_numpy(synthetic_batch(0, int(cfg.total_bs),
                                                 int(cfg.dataset.train.others.npoints))).to(dev)
    clip_pth = os.path.join(tmp, "clip_dvae.pth")
    for arch in TEACHER_ARCHS:
        t_phase = t0 = time.perf_counter()
        a_cfg = teacher_config(arch)
        model = prepare_model(a_cfg, 0, dev)
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        frozen = [k for k in init if k.startswith(tuple(f"{p}." for p in TEACHER_LAYOUT[arch][1]))]
        n_all = sum(p.numel() for p in model.parameters())
        n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
        print(f"[model] {AUTOENCODER_CONFIG} with {TEACHER_ARCHS[arch]}: {n_all} params "
              f"({n_train} trainable; the {arch} backbone frozen, {len(frozen)} tensors, its "
              f"blocks in bf16), built in {time.perf_counter() - t0:.2f} s", flush=True)
        stage1_paths_agree(model, s1_clouds, temp, kldw, dev, f"stage1 {arch}")
        del model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = counted(f"stage1 {arch} run_autoencoder_steps", lambda: run_autoencoder_steps(
            a_cfg, TK_S1_STEPS, seed=0, start_itr=S1_START_ITR, device=dev))
        peak = torch.cuda.max_memory_allocated()
        check_launches(f"stage1 {arch} run_autoencoder_steps",
                       launches[f"stage1 {arch} run_autoencoder_steps"], STAGE1_PER_STEP,
                       TK_S1_STEPS)
        after = run.model.state_dict()
        frozen_same = all(torch.equal(after[k], init[k]) for k in frozen)
        moved_keys = ["visual_prompt_token", "deep_prompt_tokens", "proj_pre.weight",
                      "decoder.final_conv.6.weight"] + (
            ["visual_embed.0.weight", "visual_embed.2.bias"] if arch == "clip" else [])
        moved = {k: not torch.equal(after[k], init[k]) for k in moved_keys}
        med = statistics.median(run.step_ms[1:])
        print(f"[stage1 {arch}] run_autoencoder_steps losses {run.losses}; the frozen backbone "
              f"bit-for-bit unchanged: {frozen_same}; moved: {moved}", flush=True)
        if not (all(map(math.isfinite, run.losses)) and frozen_same and all(moved.values())):
            fail(f"stage1 {arch}: a loss not finite, the frozen backbone moved or a trained "
                 "tensor did not")

        def step(i, run=run):
            return autoencoder_step(run.model, run.optimizer, lambda s: 1e-6, s1_clouds, i,
                                    step_rngs(0, i, dev), temp, kldw, a_cfg.grad_norm_clip)
        print(f"[time] Stage-I step B={s1_clouds.shape[0]}, {arch} teacher: median {med:.3f} "
              f"ms over steps 2-{TK_S1_STEPS}, all {[round(x, 3) for x in run.step_ms]}; "
              f"{s1_clouds.shape[0] / med * 1e3:.1f} clouds/s; peak memory "
              f"{peak / 2 ** 30:.3f} GiB", flush=True)
        busy_line(kernel_events, f"Stage-I step, {arch} teacher", lambda: step(TK_S1_STEPS), med,
                  top_n=8)
        if arch == "clip":
            torch.save({"base_model": run.model.state_dict()}, clip_pth)
        del run
        torch.cuda.empty_cache()
        print(f"[stage1 {arch}] phase 34 {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 35. Stage II with the CLIP tokenizer handed over from phase 34 ---------------
    t_phase = time.perf_counter()
    p_cfg = load_config(PRETRAIN_CONFIG)
    p_cfg.model.dvae_config.update(TEACHER_ARCHS["clip"], ckpt=clip_pth)
    model = rp.build_pretrain_model(p_cfg.model, seed=0)
    n = rp.load_dvae_ckpt(model, p_cfg.model.dvae_config)
    sd = model.state_dict()
    model = rp.freeze_tokenizer(model, p_cfg).to(dev).eval()
    tok = model.dvae_tokenizer
    stage1 = torch.load(clip_pth, map_location=dev, weights_only=True)["base_model"]
    same_blocks = all(torch.equal(p, stage1[k]) for k, p in tok.state_dict().items()
                      if k.startswith("visual_embed.1."))
    bs = int(p_cfg.total_bs)
    s2_clouds = torch.from_numpy(synthetic_batch(0, bs, npts)).to(dev)
    feats = {}
    with torch.no_grad():
        nbr, ctr = ops.group_points(s2_clouds, G, M)
        feats["kernel"] = counted("stage2 clip features", lambda: tok.forward_tokenizer_features(
            nbr, ctr, rngs=step_rngs(0, 0, dev)))
        with patched(ops, group_points=ops.group_points_ref,
                     graph_feature_idx=ops.graph_feature_idx_ref,
                     gumbel_argmax=ops.gumbel_argmax_ref):
            nbr_p, ctr_p = ops.group_points(s2_clouds, G, M)
            feats["plain"] = counted("stage2 clip features, plain",
                                     lambda: tok.forward_tokenizer_features(
                                         nbr_p, ctr_p, rngs=step_rngs(0, 0, dev)), plain=True)
        n_sw = tie_swaps(ops.furthest_point_sample(s2_clouds, G),
                         ops.furthest_point_sample_ref(s2_clouds, G))
    check_launches("stage2 clip features", launches["stage2 clip features"],
                   {"k_smallest": 2, "gumbel_argmax": 1}, 1)
    diff = float((feats["kernel"] - feats["plain"]).abs().max())
    tol = 0.0 if n_sw == 0 else FEAT_ATOL
    errs["tokenizer stage2 clip features"] = diff
    print(f"[stage2 clip] tokenizer from the Stage-I .pth: {n} tensors, its bf16 resblocks "
          f"bit-equal to Stage I's {same_blocks}; features {tuple(feats['kernel'].shape)} (eval, "
          f"the Gumbel kernel's draws from the same generator) through the kernels against the "
          f"plain path: max |diff| {diff} (tolerance {tol}: {n_sw} FPS tie swaps)", flush=True)
    if not (same_blocks and diff <= tol and torch.isfinite(feats["kernel"]).all()):
        fail("stage2 clip: the handed-over tokenizer differs or kernel and plain paths disagree")
    del model, tok, feats, nbr, ctr, nbr_p, ctr_p
    torch.cuda.empty_cache()
    run = counted("stage2 clip run_steps",
                  lambda: rp.run_steps(p_cfg, TK_S2_STEPS, seed=0, device=dev, state_dict=sd))
    check_launches("stage2 clip run_steps", launches["stage2 clip run_steps"], STAGE2_PER_STEP,
                   TK_S2_STEPS)
    after = run.model.dvae_tokenizer.state_dict()
    tok_same = all(torch.equal(after[k], stage1[k].to(after[k].dtype))
                   for k in after if "running" not in k and "num_batches" not in k)
    print(f"[stage2 clip] run_steps losses {run.losses}, step ms "
          f"{[round(x, 3) for x in run.step_ms]}; the tokenizer's parameters equal the Stage-I "
          f".pth's: {tok_same}", flush=True)
    if not (all(map(math.isfinite, run.losses)) and tok_same):
        fail("stage2 clip run_steps: a loss not finite or the tokenizer moved")
    step_ms = request_ms(lambda: pretrain_step(run.model, run.optimizer, lambda s: 1e-6,
                                               s2_clouds, 0, step_rngs(0, 0, dev)), 5)
    med = statistics.median(step_ms)
    print(f"[time] Stage-II step B={bs}, clip tokenizer: median {med:.3f} ms over 5 (after 3 "
          f"warm-up); {bs / med * 1e3:.1f} clouds/s", flush=True)
    busy_line(kernel_events, "Stage-II step, clip tokenizer", lambda: pretrain_step(
        run.model, run.optimizer, lambda s: 1e-6, s2_clouds, 0, step_rngs(0, 0, dev)), med)
    print(f"[stage2 clip] phase 35 {time.perf_counter() - t_phase:.1f} s", flush=True)
    del run, sd, stage1
    torch.cuda.empty_cache()
    return rows, errs, launches


def modelnet8k(dev, device_ms, kernel_events, measure):
    """Phases 39-41, ModelNet40 at 8192 points: 39, the offline FPS cache of a
    written synthetic tree built through the card's FPS kernel (``ModelNet``
    with ``FPS_DEVICE`` the card), its picks held to the plain version on
    every cloud, the parse and FPS clouds/s; 40, ``finetune_modelnet_8k.yaml``
    at full width (384 x 12, G=128 x M=32, B=32, bf16, seeded weights,
    synthetic clouds): FPS 8192 -> 8192 and -> 128, k-smallest (4096, 8192)
    and the gathers against their plain versions and timed,
    ``run_finetune_steps``, ``validate`` and a vote round through the kernels
    against the plain path, ``test_net``, a step of the linear and mlp-3
    variants, requests at B=1 and 32; 41, SGD with StepLR and
    ``step_per_update`` 2 on ``finetune_modelnet.yaml``: weights unchanged
    between updates, and a ``run_net`` stopped by the preemption guard
    between updates and resumed, bit-equal to the uninterrupted run. Returns
    (timing rows by kernel, errors, launches of each run)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_m8k_")
    try:
        return _modelnet8k(dev, device_ms, kernel_events, measure, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def write_modelnet_tree(root, clouds, points, classes):
    """A ``modelnet40_normal_resampled``-shaped tree of ``clouds`` train files
    of ``points`` rows ``x,y,z,nx,ny,nz`` at %.6f, ``classes`` categories;
    returns the file paths in list order."""
    import numpy as np
    rng = np.random.default_rng(0)
    names = [f"class{c:02d}" for c in range(classes)]
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    ids, paths = [], []
    for i in range(clouds):
        name = names[i % classes]
        os.makedirs(os.path.join(root, name), exist_ok=True)
        xyz = rng.normal(size=(points, 3))
        nrm = rng.normal(size=(points, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        ids.append(f"{name}_{i // classes + 1:04d}")
        paths.append(os.path.join(root, name, ids[-1] + ".txt"))
        np.savetxt(paths[-1], np.concatenate([xyz, nrm], 1), fmt="%.6f", delimiter=",")
    with open(os.path.join(root, "modelnet40_train.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return paths


def _modelnet8k(dev, device_ms, kernel_events, measure, tmp):
    import itertools

    import numpy as np
    import torch
    from act_tpu_torch import ops
    from act_tpu_torch.datasets.pointcloud_datasets import CACHE_BATCH, ModelNet
    from act_tpu_torch.datasets.transforms import scale_and_translate
    from act_tpu_torch.engine import checkpoint as ckpt_lib
    from act_tpu_torch.engine import serve
    from act_tpu_torch.engine.preemption import GUARD
    from act_tpu_torch.engine.runner_finetune import (VOTE_TIMES, build_state, finetune_config,
                                                      loaders, predict, run_finetune_steps,
                                                      run_net, test_net, test_vote_rounds,
                                                      train_transform, vote_generator,
                                                      vote_logits)
    from act_tpu_torch.engine.train_state import finetune_step, step_rngs
    from act_tpu_torch.ops import _backend, work
    from act_tpu_torch.ops.fps import tie_swaps
    from act_tpu_torch.ops.group import subset_draw
    from act_tpu_torch.utils.config import ConfigDict

    rows = {"fps": [], "k_smallest": [], "gather": []}
    errs, launches = {}, {}
    card = card_line()

    def check_fps(p, S, tag, say=True):
        """Kernel picks against the plain version's: up to adjacent tie swaps,
        the same set; returns (the plain picks, the swaps)."""
        k, r = ops.furthest_point_sample(p, S), ops.furthest_point_sample_ref(p, S)
        n_sw = tie_swaps(k, r)
        if n_sw < 0 or not torch.equal(k.sort(-1).values, r.sort(-1).values):
            fail(f"fps {tag} {tuple(p.shape)}->{S}: kernel picks differ beyond tie swaps")
        errs[f"fps 8k {tag} {tuple(p.shape)}->{S}"] = float(
            (ops.gather_points(p, k) - ops.gather_points(p, r)).abs().max())
        if say:
            print(f"[check] fps {tag} {tuple(p.shape)}->{S}: equal up to {n_sw} adjacent tie "
                  f"swaps, same set", flush=True)
        return r, n_sw

    def fps_row(p, S, n, tag):
        B_, N_ = p.shape[:2]
        rows["fps"].append(measure(
            f"({B_}, {N_}, 3)->{S} ({tag})", lambda: ops.furthest_point_sample(p, S),
            lambda: ops.furthest_point_sample_ref(p, S), None, 10, 1,
            bound_ms(p.numel() * 4 + B_ * S * 4, work.fps(B_, N_, S)), n,
            plain_events=True))

    # -- 39. the offline FPS cache through the card's FPS kernel -------------------
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "modelnet40_normal_resampled")
    os.makedirs(root)
    t0 = time.perf_counter()
    paths = write_modelnet_tree(root, CACHE_CLOUDS, CACHE_FILE_POINTS, CACHE_CLASSES)
    write_s = time.perf_counter() - t0
    npts = int(finetune_config(CONFIG_8K).npoints)
    node = ConfigDict(dict(NAME="ModelNet", DATA_PATH=root, N_POINTS=npts, NUM_CATEGORY=40,
                           USE_NORMALS=False, subset="train", FPS_DEVICE=str(dev)))
    from act_tpu_torch import native
    # this process's first FPS launch at the cache's geometry (the CUDA context, the
    # kernel's module loaded at its first launch), timed apart from the cache
    t0 = time.perf_counter()
    native.fps(np.zeros((min(CACHE_BATCH, CACHE_CLOUDS), CACHE_FILE_POINTS, 3), np.float32),
               npts, dev)
    first_s = time.perf_counter() - t0
    _backend.reset_launches()
    ds = ModelNet(node)
    torch.cuda.synchronize()
    launches["cache"] = dict(_backend.LAUNCHES)
    check_launches("cache build", launches["cache"], {"fps": 1},
                   -(-CACHE_CLOUDS // CACHE_BATCH))
    secs = ds.cache_seconds
    parse_rate, fps_rate = secs["clouds"] / secs["parse"], secs["clouds"] / secs["fps"]
    stack = np.stack([np.loadtxt(p, delimiter=",").astype(np.float32) for p in paths])
    xyz = torch.from_numpy(stack[..., :3]).to(dev).contiguous()
    picks = ops.furthest_point_sample(xyz, npts).long().cpu().numpy()
    check_fps(xyz, npts, "cache")
    if not all(np.array_equal(got, cloud[ix]) for got, cloud, ix in
               zip(ds.list_of_points, stack, picks)):
        fail("cache: a cloud is not its file's rows at the kernel's picks")
    again = ModelNet(node)
    if hasattr(again, "cache_seconds") or not all(
            np.array_equal(a, b) for a, b in zip(again.list_of_points, ds.list_of_points)):
        fail("cache: the file read back differs from the clouds built")
    print(f"[cache] {CACHE_CLOUDS} synthetic files of {CACHE_FILE_POINTS} x 6 rows ({write_s:.1f} "
          f"s to write): built in launches of {CACHE_BATCH} clouds through the FPS kernel "
          f"({launches['cache']['fps']} launch(es)); every cloud the file's rows at the "
          f"kernel's picks, the picks equal to the plain version's up to tie swaps; the "
          f"file read back equal", flush=True)
    project = MODELNET_CLOUDS / parse_rate + MODELNET_CLOUDS / fps_rate
    print(f"[time] cache: parse (np.loadtxt, as JAX) {secs['parse']:.3f} s = {parse_rate:.1f} clouds/s, FPS on the card (with transfers) "
          f"{secs['fps']:.3f} s = {fps_rate:.1f} clouds/s; projected to ModelNet40's "
          f"{MODELNET_CLOUDS} clouds {project:.1f} s; the process's first FPS launch at that "
          f"geometry (CUDA context, module load) {first_s:.2f} s before it ({card})", flush=True)
    fps_row(xyz, npts, 0, "the cache's launch")
    del stack, xyz, ds, again
    print(f"[m8k] phase 39 {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 40. finetune_modelnet_8k at full width ------------------------------------
    t_phase = time.perf_counter()
    cfg = finetune_config(CONFIG_8K)
    npoints, G, M = int(cfg.npoints), int(cfg.model.num_group), int(cfg.model.group_size)
    train_loader, val_loader = loaders(cfg, 0, device=dev)
    bs, vbs = train_loader.batch_size, val_loader.batch_size
    batches = list(itertools.islice(train_loader, M8_STEPS))
    val = list(itertools.islice(val_loader, M8_VAL_BATCHES))
    clouds = torch.from_numpy(batches[0][2][0]).to(dev)
    vclouds = torch.from_numpy(val[0][2][0]).to(dev)
    with torch.inference_mode():
        sub = subset_draw(bs, npoints, npoints, torch.Generator(device=dev).manual_seed(9), dev)
        tpts = ops.gather_points(clouds, sub)
        tc, _ = check_fps(tpts, G, "train groups")
        centers = ops.gather_points(tpts, tc)
        td = ops.square_distance(centers, tpts).reshape(bs * G, npoints)
        (kv, ki), (rv, ri) = ops.k_smallest(td, M), ops.k_smallest_ref(td, M)
        if not (torch.equal(ki, ri) and torch.equal(kv, rv)):
            fail(f"k_smallest {tuple(td.shape)} k={M}: differs from the plain version")
        errs[f"k_smallest 8k {tuple(td.shape)}"] = 0.0
        vres, _ = check_fps(vclouds, npoints, "validation resample (S = N)")
        if not torch.equal(vres.sort(-1).values,
                           torch.arange(npoints, device=dev, dtype=vres.dtype).expand_as(vres)):
            fail("fps S = N: not every point picked once")
        check_fps(clouds, npoints, "B=32 request resample (S = N)")
        check_fps(clouds[:1].contiguous(), npoints, "B=1 request resample (S = N)")
        vpts = ops.gather_points(vclouds, vres)
        vc, _ = check_fps(vpts, G, "validation groups")
        vd = ops.square_distance(ops.gather_points(vpts, vc), vpts).reshape(vbs * G, npoints)
        (kv, ki), (rv, rvi) = ops.k_smallest(vd, M), ops.k_smallest_ref(vd, M)
        if not (torch.equal(ki, rvi) and torch.equal(kv, rv)):
            fail(f"k_smallest {tuple(vd.shape)} k={M}: differs from the plain version")
        errs[f"k_smallest 8k {tuple(vd.shape)}"] = 0.0
        print(f"[check] k_smallest {tuple(td.shape)} and {tuple(vd.shape)} k={M}: indices "
              f"equal, values bit-equal", flush=True)
        gathers = [(clouds, sub, "train resample (a subset of the cloud)", 1),
                   (tpts, tc, "centers", 1), (tpts, ri.reshape(bs, G * M), "neighbourhoods", 1),
                   (vclouds, vres, "eval resample (S = N)", 0)]
        for p, i, tag, _ in gathers:
            if not torch.equal(ops.gather_coords(p, i), ops.gather_points(p, i)):
                fail(f"gather {tag} {tuple(p.shape)} by {tuple(i.shape)}: not bit-equal")
            errs[f"gather 8k {tag}"] = 0.0
        print("[check] gather: bit-equal at " + ", ".join(
            f"{tag} {tuple(p.shape)} by {tuple(i.shape)}" for p, i, tag, _ in gathers), flush=True)
        fps_row(tpts, G, 1, "train groups")
        fps_row(clouds, npoints, 0, "B=32 request and validation resample")
        fps_row(clouds[:1].contiguous(), npoints, 0, "B=1 request")
        for d, n, tag in ((td, 1, "train"), (vd, 0, "validation B=64")):
            rows["k_smallest"].append(measure(
                f"({d.shape[0]}, {d.shape[1]}) k={M} ({tag})", lambda d=d: ops.k_smallest(d, M),
                lambda d=d: ops.k_smallest_ref(d, M),
                lambda d=d: torch.topk(d, M, dim=-1, largest=False, sorted=True), 50, 10,
                bound_ms(d.numel() * 4 + d.shape[0] * M * 8, d.numel()), n))
        for p, i, tag, n in gathers:
            li = i.long().reshape(p.shape[0], -1, 1).expand(-1, -1, p.shape[-1]).contiguous()
            rows["gather"].append(measure(
                f"{tag} {tuple(p.shape)} by {tuple(i.shape)}, {distinct_rows(i)} rows read",
                lambda p=p, i=i: ops.gather_coords(p, i), lambda p=p, i=i: ops.gather_points(p, i),
                lambda p=p, li=li: torch.gather(p, 1, li), 200, 200,
                bound_ms(distinct_rows(i) * p.shape[-1] * 4 + i.numel() * 4
                         + i.numel() * p.shape[-1] * 4), n))
    print_times("8k ", rows)

    t0 = time.perf_counter()
    st = build_state(cfg, len(train_loader), 0, dev)
    model = st.model
    print(f"[model] {CONFIG_8K}: {sum(p.numel() for p in model.parameters())} params, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _backend.reset_launches()
    run = run_finetune_steps(cfg, M8_STEPS, batches=batches, seed=0, device=dev, state=st)
    launches["8k steps"] = dict(_backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_launches("8k run_finetune_steps", launches["8k steps"], FT8K_PER_STEP, M8_STEPS)
    moved = sum(not torch.equal(model.state_dict()[n], init[n])
                for n, p in model.named_parameters() if p.requires_grad)
    n_train = sum(p.requires_grad for p in model.parameters())
    if not all(map(math.isfinite, run.losses)) or moved != n_train:
        fail(f"8k steps: losses {run.losses}, {moved} of {n_train} trainable tensors moved")
    med = statistics.median(run.step_ms[1:])
    step_args = (clouds, torch.from_numpy(batches[0][2][1]).to(dev))
    busy = busy_line(kernel_events, f"8k finetune step B={bs}", lambda: finetune_step(
        model, st.optimizer, lambda s: 1e-6, *step_args, 0, step_rngs(0, 0, dev),
        train_transform(npoints), st.grad_norm_clip), med, iters=2)
    print(f"[time] 8k finetune step B={bs}: losses {run.losses}; host ms "
          f"{[round(x, 3) for x in run.step_ms]}, median of steps 2-{M8_STEPS} {med:.3f} ms; "
          f"{bs / med * 1e3:.1f} clouds/s; device busy "
          f"{'not measured' if busy is None else f'{busy:.3f} ms'}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB ({card})", flush=True)

    model.eval()
    _backend.reset_launches()
    t0 = time.perf_counter()
    logits_k, labs = predict(model, val, npoints, dev)
    val_ms = (time.perf_counter() - t0) * 1e3
    launches["8k validate"] = dict(_backend.LAUNCHES)
    check_launches("8k validate", launches["8k validate"], FT8K_PER_EVAL, len(val))
    with patched(serve, furthest_point_sample=ops.furthest_point_sample_ref,
                 gather_coords=ops.gather_points), patched(ops, group_points=ops.group_points_ref):
        _backend.reset_launches()
        logits_p, _ = predict(model, val, npoints, dev)
        if any(_backend.LAUNCHES.values()):
            fail(f"the plain-version validate launched kernels: {_backend.LAUNCHES}")
    swaps = 0
    for b in val:
        vb = torch.from_numpy(b[2][0]).to(dev)
        r, n_sw = check_fps(vb, npoints, "validation", False)
        swaps += n_sw + check_fps(ops.gather_points(vb, r), G, "validation groups", False)[1]
    diff = float(np.abs(logits_k - logits_p).max())
    print(f"[check] 8k validate logits ({len(val)} batches of {vbs}): kernel path against plain "
          f"path max |diff| {diff} (tolerance: bit-equal, or {LOGIT_ATOL} with FPS tie swaps; "
          f"{swaps} counted); OA {float((logits_k.argmax(-1) == labs).mean()) * 100:.4f}; "
          f"{len(labs) / val_ms * 1e3:.1f} clouds/s ({val_ms:.1f} ms host)", flush=True)
    if not (np.array_equal(logits_k, logits_p) or (swaps and diff <= LOGIT_ATOL)):
        fail("8k validate: kernel path and plain path disagree")

    def fps_subsample_plain(xyz, nf, n_out, gen):
        sub = subset_draw(xyz.shape[0], min(nf, xyz.shape[1]), n_out, gen, xyz.device)
        return ops.gather_points(xyz, sub)  # nf = N: the subset of the cloud itself
    with torch.inference_mode():
        _backend.reset_launches()
        probs_k = vote_logits(model, vclouds, npoints, vote_generator(0, 0, 0, dev))
        launches["8k vote"] = dict(_backend.LAUNCHES)
        check_launches("8k vote_logits", launches["8k vote"], FT8K_PER_STEP, VOTE_TIMES)
        with patched(ops, fps_subsample=fps_subsample_plain, group_points=ops.group_points_ref):
            probs_p = vote_logits(model, vclouds, npoints, vote_generator(0, 0, 0, dev))
        gen, vswaps = vote_generator(0, 0, 0, dev), 0  # the draws replayed: the swaps
        for _ in range(VOTE_TIMES):
            moved = scale_and_translate(fps_subsample_plain(vclouds, npoints, npoints, gen), gen)
            vswaps += check_fps(moved.contiguous(), G, "vote groups", False)[1]
    vdiff = float((probs_k - probs_p).abs().max())
    t0 = time.perf_counter()
    rounds = test_vote_rounds(model, val[:1], npoints, 0, 1, device=dev)
    vote_ms = (time.perf_counter() - t0) * 1e3
    print(f"[check] 8k vote summed probabilities ({VOTE_TIMES} votes, B={vbs}): kernel path "
          f"against plain path max |diff| {vdiff} (tolerance: bit-equal, or {LOGIT_ATOL} with "
          f"FPS tie swaps; {vswaps} counted); one vote round on a batch: OA "
          f"{rounds.tolist()}, {vote_ms:.1f} ms host", flush=True)
    if (not (vdiff == 0.0 or (vswaps and vdiff <= LOGIT_ATOL))
            or not all(map(math.isfinite, rounds))):
        fail("8k vote: kernel path and plain path disagree, or a round is not finite")

    path = ckpt_lib.save_checkpoint(model, st.optimizer, M8_STEPS, 0, None, None, "ckpt-last",
                                    tmp)
    t0 = time.perf_counter()
    _backend.reset_launches()
    acc = test_net(cfg, ckpts=path, seed=0, device=dev)
    test_s = time.perf_counter() - t0
    launches["8k test_net"] = dict(_backend.LAUNCHES)
    n_test = len(val_loader)
    check_launches("8k test_net", launches["8k test_net"], FT8K_PER_EVAL, n_test)
    print(f"[m8k] test_net: OA {acc.acc:.4f}, mAcc {acc.macc:.4f} over {n_test} batches, "
          f"{test_s:.1f} s with the model's build", flush=True)
    if not (math.isfinite(acc.acc) and math.isfinite(acc.macc)):
        fail("8k test_net: metrics not finite")

    infer = serve.build_infer_fn(model, npoints)
    req = {}
    for b_, iters in zip((1, bs), M8_REQ_ITERS):
        x = clouds[:b_].contiguous()
        _backend.reset_launches()
        out = infer(x)
        torch.cuda.synchronize()
        launches[f"8k request b{b_}"] = dict(_backend.LAUNCHES)
        check_launches(f"8k request B={b_}", launches[f"8k request b{b_}"], FT8K_PER_EVAL, 1)
        if tuple(out.shape) != (b_, int(cfg.model.cls_dim)) or not bool(torch.isfinite(out).all()):
            fail(f"8k request B={b_}: logits {tuple(out.shape)} not finite or misshapen")
        lat = request_ms(lambda: infer(x), iters)
        req[b_] = statistics.median(lat)
        busy = busy_line(kernel_events, f"8k request B={b_}", lambda: infer(x), req[b_])
        print(f"[time] 8k request B={b_} ({npoints} points each): median {req[b_]:.3f} ms, "
              f"min {min(lat):.3f}, max {max(lat):.3f} over {iters}; {b_ / req[b_] * 1e3:.1f} "
              f"clouds/s; device busy {'not measured' if busy is None else f'{busy:.3f} ms'} "
              f"({card})", flush=True)
    del model, st, run, infer
    torch.cuda.empty_cache()

    for yaml in CONFIGS_8K_HEADS:
        hcfg = finetune_config(yaml)
        _backend.reset_launches()
        hrun = run_finetune_steps(hcfg, 1, batches=batches[:1], seed=0, device=dev)
        tag = f"8k {hcfg.model.transfer_type} step"
        launches[tag] = dict(_backend.LAUNCHES)
        check_launches(tag, launches[tag], FT8K_PER_STEP, 1)
        n_tr = sum(p.numel() for p in hrun.state.model.parameters() if p.requires_grad)
        print(f"[m8k] {yaml}: one step, loss {hrun.losses[0]:.6f}, {hrun.step_ms[0]:.1f} ms host "
              f"(the first step); {n_tr} trainable parameters", flush=True)
        if not math.isfinite(hrun.losses[0]):
            fail(f"{tag}: loss not finite")
        del hrun
        torch.cuda.empty_cache()
    print(f"[m8k] phase 40 {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 41. SGD + StepLR, step_per_update 2; stopped between updates, resumed -----
    t_phase = time.perf_counter()
    ocfg = finetune_config(CONFIG)
    ocfg.optimizer = ConfigDict(dict(type="SGD", kwargs=dict(lr=0.01, weight_decay=1e-4)))
    ocfg.scheduler = ConfigDict(dict(type="StepLR", kwargs=dict(step_size=1, gamma=0.7)))
    ocfg.step_per_update = OPT_EVERY
    (oloader,) = loaders(ocfg, 0, ("train",), device=dev)
    obatches = list(itertools.islice(oloader, OPT_STEPS))
    ost = build_state(ocfg, len(oloader), 0, dev)
    trained = [n for n, p in ost.model.named_parameters() if p.requires_grad]
    prev = {n: ost.model.get_parameter(n).detach().clone() for n in trained}
    pattern = []
    _backend.reset_launches()
    for i, b in enumerate(obatches):
        run_finetune_steps(ocfg, 1, batches=[b], seed=0, device=dev, state=ost, start_step=i)
        now = {n: ost.model.get_parameter(n).detach().clone() for n in trained}
        pattern.append(sum(not torch.equal(now[n], prev[n]) for n in trained))
        prev = now
    launches["options steps"] = dict(_backend.LAUNCHES)
    check_launches("options steps", launches["options steps"], FINETUNE_PER_STEP, OPT_STEPS)
    want = [len(trained) if (i + 1) % OPT_EVERY == 0 else 0 for i in range(OPT_STEPS)]
    opt = ost.optimizer
    print(f"[opt] SGD + StepLR, step_per_update {OPT_EVERY}: trainable tensors moved after each "
          f"of {OPT_STEPS} micro-steps {pattern} (expected {want}); updates {opt.updates}, "
          f"micro-step {opt.mini_step}", flush=True)
    if pattern != want or (opt.updates, opt.mini_step) != (OPT_STEPS // OPT_EVERY, 0):
        fail("step_per_update: the weights moved between updates or not on them")
    del ost, opt
    GUARD.reset()
    try:
        whole = run_net(ocfg, seed=0, device=dev, epochs=1, max_steps=OPT_STEPS,
                        experiment_path=os.path.join(tmp, "a"))
        GUARD.at_step = OPT_STOP
        cut = run_net(ocfg, seed=0, device=dev, epochs=1, max_steps=OPT_STEPS,
                      experiment_path=os.path.join(tmp, "b"))
        GUARD.reset()
        GUARD.at_step = None
        saved = torch.load(os.path.join(tmp, "b", "ckpt-last.pth"), map_location="cpu",
                           weights_only=True)["optimizer"]
        rest = run_net(ocfg, seed=0, device=dev, epochs=1, max_steps=OPT_STEPS - OPT_STOP,
                       resume=True, experiment_path=os.path.join(tmp, "b"))
    finally:
        GUARD.reset()
        GUARD.at_step = None
    a, b = whole.state, rest.state
    same_w = all(torch.equal(x, b.model.state_dict()[k]) for k, x in a.model.state_dict().items())
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    same_o = ((sa["mini_step"], sa["updates"]) == (sb["mini_step"], sb["updates"])
              and all(torch.equal(x, y) for x, y in zip(sa["acc"], sb["acc"]))
              and all(torch.equal(s["momentum_buffer"], sb["inner"]["state"][i]["momentum_buffer"])
                      for i, s in sa["inner"]["state"].items()))
    print(f"[opt] run_net {OPT_STEPS} micro-steps against one stopped after micro-step "
          f"{OPT_STOP} (saved between updates: micro-step {saved['mini_step']}, "
          f"{saved['updates']} update(s), the mean of {saved['mini_step']} gradient(s)) and "
          f"resumed: preempted {cut.preempted}; weights and statistics bit-equal {same_w}; "
          f"momentum, accumulated gradients and counts bit-equal {same_o}", flush=True)
    if not (cut.preempted and (saved["mini_step"], saved["updates"]) == (1, 1) and same_w
            and same_o and rest.steps == whole.steps == OPT_STEPS):
        fail("step_per_update: the resume from between updates is not the uninterrupted run")
    from act_tpu_torch.utils.writer import get_writer
    writer = get_writer(os.path.join(tmp, "TFBoard"))  # rank 0: SummaryWriter if it imports
    writer.add_scalar("Loss/Batch/Loss", whole.epoch_loss[0], whole.steps)
    writer.close()
    print(f"[opt] the CLIs' writer on this machine: {type(writer).__name__}", flush=True)
    print(f"[m8k] phase 41 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows, errs, launches


def parity(dev, device_ms, kernel_events, measure):
    """Phase 42, the MODEL_ZOO parity protocol (``act_tpu_torch.parity_protocol``)
    on the card: fabricated full-width files in the released layouts (a
    PointTransformer for each ScanObjectNN config and for ModelNet40, a
    Stage-II ``ACT_PointDistillation`` with ``ACT_encoder.`` keys, a
    ``SemSegTransformer`` in ``{'model_state_dict': ...}`` with the head keys of
    the released file, the prompted-ViT dVAE), every row of ``PARITY_ROWS`` on
    synthetic data with the length bounds above, each row's result finite and
    in range and the kernels of ``PARITY_KERNELS`` launched; the
    ``scan_hardest`` test OA against a CPU run of the same file and batches
    (within one cloud; both in f32, TF32 off); the part-seg dumps of
    ``part_segmentation_vis``. Checked and untimed: it runs beside phase 37's
    tracing. Returns (no timing rows, no errors, each row's launches)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_parity_")
    try:
        return {}, {}, _parity(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parity_files(tmp):
    """The fabricated released files of phase 42, from seeds: name -> path."""
    import torch
    from act_tpu_torch import parity_protocol as pp
    from act_tpu_torch.engine import serve
    from act_tpu_torch.engine.runner_autoencoder import build_autoencoder_model
    from act_tpu_torch.engine.runner_finetune import finetune_config
    from act_tpu_torch.engine.runner_pretrain import build_pretrain_model
    from act_tpu_torch.models import MODELS

    def classifier(cfg_path, seed):
        with torch.device("meta"):
            model = MODELS.build(finetune_config(cfg_path).model)
        model = model.to_empty(device="cpu")
        model.init_weights(torch.Generator().manual_seed(seed))
        return {"base_model": model.state_dict()}

    def dvae(seed):
        cfg = serve.load_config(pp.DVAE_TASKS["dvae"])
        return {"base_model": build_autoencoder_model(cfg.model, seed).state_dict()}

    made = {task: (lambda c=cfg, i=i: classifier(c, 20 + i))
            for i, (task, (cfg, _)) in enumerate(pp.TASKS.items())}
    made["pretrain"] = lambda: {"base_model": build_pretrain_model(
        serve.load_config(PRETRAIN_CONFIG).model, 30).state_dict()}
    made["s3dis"] = lambda: {"model_state_dict": serve.load_seg_model(
        "semseg", None, 128, "f32", 31, "cpu").state_dict(), "epoch": 59}
    made["partseg"] = lambda: {"base_model": serve.load_seg_model(
        "partseg", None, 128, "f32", 32, "cpu").state_dict()}
    made["dvae"] = lambda: dvae(33)
    paths = {}
    for name, make in made.items():
        paths[name] = os.path.join(tmp, f"released_{name}.pth")
        torch.save(make(), paths[name])
    return paths


def _parity(dev, tmp):
    import numpy as np
    from act_tpu_torch import parity_protocol as pp
    from act_tpu_torch import part_segmentation_vis
    from act_tpu_torch.engine.serve import load_config
    from act_tpu_torch.ops import _backend

    t_phase = time.perf_counter()
    files = parity_files(tmp)
    print(f"[parity] fabricated {len(files)} full-width released files "
          f"({sum(os.path.getsize(p) for p in files.values()) / 2 ** 20:.1f} MiB): "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    bounds = dict(max_batches=PARITY_BATCHES, vote_rounds=PARITY_ROUNDS, folds=[0], epochs=1,
                  max_steps=PARITY_STEPS)
    launches, results = {}, {}
    for row, (file, flags) in PARITY_ROWS.items():
        task = row.split()[0]
        kw = dict(bounds, **flags)
        if task == "s3dis":
            kw.update(max_batches=1, vote_rounds=1)
        elif task == "dvae":
            kw.update(max_batches=PARITY_DVAE)
        t0 = time.perf_counter()
        _backend.reset_launches()
        res = pp.run_protocol(task, files[file], device=dev, work_dir=tmp,
                              exp_name="parity_" + row.replace(" ", "").replace("-", "_"), **kw)
        launches[row] = dict(_backend.LAUNCHES)
        secs = time.perf_counter() - t0
        results[row] = res
        print(f"[parity] {row} {secs:.1f} s", flush=True)
        print(f"[parity] {row}: {json.dumps(res)}", flush=True)
        kind = task if task in ("s3dis", "dvae") else "cls"
        missing = [k for k in PARITY_KERNELS[kind] if launches[row][k] == 0]
        if missing:
            fail(f"parity {row}: the kernels {missing} were not launched ({launches[row]})")
        values = list(res["metrics"].values()) if task == "dvae" else [res["ours"]]
        if not all(math.isfinite(v) for v in values):
            fail(f"parity {row}: a result is not finite: {res}")
        if task != "dvae" and not 0.0 <= res["ours"] <= 100.0:
            fail(f"parity {row}: {res['ours']} is not a percentage")
        if task == "s3dis":  # each S3DIS forward: 1 FPS, the k=32 kNN and the k=3 3-NN
            got = launches[row]
            if got["k_smallest"] != 2 * got["fps"]:
                fail(f"parity s3dis: {got['k_smallest']} k-smallest launches for {got['fps']} "
                     "forwards, not the kNN and the 3-NN of each")
        if task == "dvae":
            check_launches("parity dvae", launches[row], VALIDATE_PER_CLOUD, PARITY_DVAE)
    t0 = time.perf_counter()
    cpu = pp.run_protocol("scan_hardest", files["scan_hardest"], device="cpu", work_dir=tmp,
                          exp_name="parity_scan_hardest_cpu", **bounds)
    card = results["scan_hardest"]["ours"]
    clouds = PARITY_BATCHES * 2 * int(load_config(pp.TASKS["scan_hardest"][0]).total_bs)
    print(f"[parity] scan_hardest test OA over {clouds} clouds: card {card:.4f}, CPU "
          f"{cpu['ours']:.4f} (f32, TF32 off; the CPU run {time.perf_counter() - t0:.1f} s)",
          flush=True)
    if abs(card - cpu["ours"]) > 100.0 / clouds + 1e-9:
        fail("parity scan_hardest: the card's test OA is more than one cloud from the CPU's")
    t0 = time.perf_counter()
    _backend.reset_launches()
    out = os.path.join(tmp, "vis")
    written = part_segmentation_vis.main(["--ckpts", files["partseg"], "--out", out,
                                          "--num_shapes", str(PARITY_SHAPES),
                                          "--device", str(dev)])
    launches["part_segmentation_vis"] = dict(_backend.LAUNCHES)
    npoint = part_segmentation_vis.parse_args([]).npoint
    shapes = [np.loadtxt(p).shape for p in written]
    print(f"[parity] part_segmentation_vis {time.perf_counter() - t0:.1f} s: {len(written)} "
          f"dumps {[os.path.basename(p) for p in written]} of shapes {shapes}", flush=True)
    if len(written) != PARITY_SHAPES or any(s != (npoint, 5) for s in shapes):
        fail(f"parity: the dumps are not {PARITY_SHAPES} files of {npoint} rows x 5 columns")
    if any(launches["part_segmentation_vis"][k] == 0 for k in SEG_PER_FORWARD):
        fail(f"parity dumps: kernels not launched ({launches['part_segmentation_vis']})")
    print(f"[parity] phase 42 {time.perf_counter() - t_phase:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(finetune_variants(dev))
    print(f"[variant] phase 46 {time.perf_counter() - t0:.1f} s ({len(VARIANT_CONFIGS)} configs)",
          flush=True)
    return launches


def dvae_tsne(dev, device_ms, kernel_events, measure):
    """Phases 43 and 36 (``plain_dvae``, then ``tsne``), each alone on the
    card, in one child process: a child's start-up (CUDA, the kernels' lazy
    loading) cost 12-17 s (NVIDIA H100 80GB HBM3, 700 W). Phase 43 opens one profiler
    window, so phase 36's come early in the process (a window late in a
    process loses records: after phases 43 and 39-41 every t-SNE row fell
    back to CUDA events). Returns (timing rows and launches by phase name,
    errors)."""
    out = {name: globals()[name](dev, device_ms, kernel_events, measure)
           for name in ("plain_dvae", "tsne")}
    errs = {k: v for r in out.values() for k, v in r[1].items()}
    return {n: r[0] for n, r in out.items()}, errs, {n: r[2] for n, r in out.items()}


def profile_kernel(name: str):
    """The Stage-II kernel (``PROFILE_FUNCTIONS``) whose device function a
    trace's kernel ``name`` is, else None."""
    import re
    ident = re.sub(r"\(anonymous namespace\)::", "", name)
    ident = re.split(r"[<(]", ident.replace("void ", "", 1), maxsplit=1)[0].split("::")[-1]
    return next((k for k, fns in PROFILE_FUNCTIONS.items() if ident.strip() in fns), None)


def trace_counts(tr) -> dict:
    """The launches of each Stage-II kernel in a trace (``profile_step.read_trace``)."""
    counts = {k: 0 for k in PROFILE_FUNCTIONS}
    for name, _, _ in tr.kernels:
        k = profile_kernel(name)
        if k is not None:
            counts[k] += 1
    return counts


def profiled(dev, device_ms, kernel_events, measure):
    """Phase 47 (``chip_smoke.py --profile``, a child alone on the card). (i)
    ``python -m act_tpu_torch.profile_step``'s capture of the full-width
    Stage-II step (``setup_pretrain``, B=128): 2 warm steps, a window of
    ``STEPS`` = 3; its kernel table counts exactly ``STEPS`` x
    ``STAGE2_PER_STEP`` of the four kernels and the framework table as many
    calls of their ``act_tpu_torch::<kernel>`` rows, the framework table's rows sum
    to the kernel table's total within ``PROFILE_SUM_RTOL``, and that total a
    step lies within ``PROFILE_RTOL`` of ``device_ms`` of the step; both
    tables' top ``PROFILE_TOP`` rows printed. (ii) Stage II's ``run_net``
    (phase 21's config at ``cut_depth``, no probe, a random tokenizer) at
    B=``TRACE_B`` for one epoch of the synthetic ShapeNet-55, with
    ``ACT_TPU_PROFILE`` set and without: one trace of exactly the steps of
    ``TRACE_WINDOW`` (their kernels and ``ADAMW_RANGE`` ranges), the losses,
    weights and statistics bit-equal. (iii) ``utils.misc.random_dropping``
    at ``DROP_SHAPE``, G=``DROP_G``, M=``DROP_M`` through the kernels against
    its plain version. Returns (no timing rows, errors, launches)."""
    import tempfile
    import torch
    from act_tpu_torch import ops, profile_step
    from act_tpu_torch.engine import runner_pretrain
    from act_tpu_torch.engine.serve import load_config
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.ops.fps import tie_swaps
    from act_tpu_torch.utils import misc, profiling as trace_mod

    t_phase, errs, launches = time.perf_counter(), {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        # -- (i) the per-op profile of the full-width Stage-II step
        wl = profile_step.setup_pretrain(dev)
        torch.cuda.synchronize()
        _backend.reset_launches()
        path = profile_step.capture(wl, os.path.join(tmp, "step"), dev)
        launches["profile capture"] = dict(_backend.LAUNCHES)
        check_launches("profile capture", launches["profile capture"], STAGE2_PER_STEP,
                       profile_step.WARM + profile_step.STEPS)
        tr = profile_step.read_trace(path)
        krows, orows = profile_step.kernel_rows(tr), profile_step.op_rows(tr)
        total, op_total = sum(r[2] for r in krows), sum(r[2] for r in orows)
        counts = trace_counts(tr)
        batch = wl.batch(99)
        dm = device_ms(lambda: wl.step(99, batch), profile_step.STEPS)
        per_step = total / profile_step.STEPS
        for tool in profile_step.TOOLS:
            print(f"[profile] {tool}, top {PROFILE_TOP}:\n"
                  + profile_step.report(path, tool, PROFILE_TOP), flush=True)
        print(f"[profile] Stage-II step B={wl.B}: {tr.steps} steps in the window; kernel table "
              f"{len(krows)} names, {sum(r[1] for r in krows)} launches, {total:.6f} ms "
              f"({per_step:.6f} ms a step); framework table {len(orows)} ops, {op_total:.6f} ms "
              f"(tolerance {PROFILE_SUM_RTOL}); device_ms of the step {dm} (tolerance "
              f"{PROFILE_RTOL}); Stage-II kernels in the window {counts}", flush=True)
        want = {k: v * profile_step.STEPS for k, v in STAGE2_PER_STEP.items()}
        named = {k: next((c for n, c, _ in orows if n == f"act_tpu_torch::{k}"), 0)
                 for k in STAGE2_PER_STEP}
        print(f"[profile] the framework table's act_tpu_torch::<kernel> rows (the ops of FPS, "
              f"k-smallest and the gather, the Gumbel wrapper's range), calls: {named}",
              flush=True)
        if tr.steps != profile_step.STEPS or counts != want or named != want:
            fail(f"profile: the window holds {tr.steps} steps, kernels {counts} and op rows "
                 f"{named}, expected {profile_step.STEPS} and {want}")
        if abs(op_total - total) > PROFILE_SUM_RTOL * total:
            fail(f"profile: the framework table sums to {op_total} ms, the kernels to {total}")
        if dm is None or abs(per_step - dm) > PROFILE_RTOL * dm:
            fail(f"profile: {per_step} ms a step in the trace against device_ms {dm}")
        del wl, batch

        # -- (ii) run_net's trace window, bit-equal to the run without it
        cfg = cut_depth(load_config(PRETRAIN_CONFIG))
        del cfg.dataset["val"], cfg.dataset["extra_train"]
        cfg.model.dvae_config.ckpt = None
        cfg.total_bs = TRACE_B
        runs, out = {}, os.path.join(tmp, "run_net")
        for tag, env in (("plain", None), ("traced", out)):
            if env is None:
                os.environ.pop(trace_mod.ENV, None)
            else:
                os.environ[trace_mod.ENV] = env
            try:
                _backend.reset_launches()
                t0 = time.perf_counter()
                runs[tag] = runner_pretrain.run_net(
                    cfg, device=dev, epochs=1, experiment_path=os.path.join(tmp, tag))
                torch.cuda.synchronize()
                launches[f"run_net {tag}"] = dict(_backend.LAUNCHES)
                print(f"[profile] Stage-II run_net ({tag}): {runs[tag].step} steps at "
                      f"B={TRACE_B}, {time.perf_counter() - t0:.2f} s", flush=True)
            finally:
                os.environ.pop(trace_mod.ENV, None)
            check_launches(f"run_net {tag}", launches[f"run_net {tag}"], STAGE2_PER_STEP,
                           runs[tag].step)
        traces = sorted(os.listdir(out)) if os.path.isdir(out) else []
        if len(traces) != 1:
            fail(f"run_net with {trace_mod.ENV} wrote {traces}, not one trace")
        path = os.path.join(out, traces[0])
        tr = profile_step.read_trace(path)
        with open(path) as f:
            adamw = sum(e.get("cat") == "user_annotation" and e.get("name") == ADAMW_RANGE
                        for e in json.load(f)["traceEvents"])
        n = TRACE_WINDOW[1] - TRACE_WINDOW[0]
        counts = trace_counts(tr)
        want = {k: v * n for k, v in STAGE2_PER_STEP.items()}
        a, b = runs["plain"], runs["traced"]
        same = a.epoch_loss == b.epoch_loss and all(
            torch.equal(t, b.model.state_dict()[k]) for k, t in a.model.state_dict().items())
        print(f"[profile] run_net with {trace_mod.ENV}: one trace of {tr.steps} steps, "
              f"Stage-II kernels {counts}, {adamw} AdamW ranges; losses {b.epoch_loss}, weights "
              f"and statistics bit-equal to the run without it: {same}", flush=True)
        print("[profile] run_net window, framework_op_stats top 5:\n"
              + profile_step.report(path, "framework_op_stats", 5), flush=True)
        if tr.steps != n or counts != want or adamw != n:
            fail(f"run_net trace: {tr.steps} steps, {counts}, {adamw} AdamW ranges; expected "
                 f"{n}, {want}, {n}")
        if not same or a.step < TRACE_WINDOW[1] + 1:
            fail("run_net with the trace window differs from the run without it")
        del runs, a, b

        # -- (iii) random_dropping through the kernels against its plain version
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(*DROP_SHAPE, generator=gen).to(dev)
        _backend.reset_launches()
        got = misc.random_dropping(x, torch.Generator(device=dev).manual_seed(0),
                                   DROP_M, num_group=DROP_G)
        torch.cuda.synchronize()
        launches["random_dropping"] = dict(_backend.LAUNCHES)
        check_launches("random_dropping", launches["random_dropping"], DROP_PER_CALL, 1)
        plain_knn = lambda ref, q, k: ops.k_smallest_ref(ops.square_distance(q, ref), k)  # noqa: E731
        with patched(ops, furthest_point_sample=ops.furthest_point_sample_ref,
                     gather_coords=ops.gather_points, knn=plain_knn):
            _backend.reset_launches()
            want = misc.random_dropping(x, torch.Generator(device=dev).manual_seed(0),
                                        DROP_M, num_group=DROP_G)
            torch.cuda.synchronize()
            if any(_backend.LAUNCHES.values()):
                fail("the plain random_dropping launched kernels")
        swaps = tie_swaps(ops.furthest_point_sample(x, DROP_G),
                          ops.furthest_point_sample_ref(x, DROP_G))
        errs["random_dropping"] = (got - want).abs().max().item()
        print(f"[profile] random_dropping {DROP_SHAPE}, G={DROP_G}, M={DROP_M}: launches "
              f"{launches['random_dropping']}; against the plain version max |diff| "
              f"{errs['random_dropping']} (bit-equal: {torch.equal(got, want)}; {swaps} FPS tie "
              f"swaps); phase 47 {time.perf_counter() - t_phase:.1f} s", flush=True)
        if tuple(got.shape) != DROP_SHAPE or (swaps == 0 and not torch.equal(got, want)):
            fail("random_dropping: the kernel path differs from the plain version")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {}, errs, launches


def tool_output(main, argv) -> str:
    """What ``main(argv)`` prints, printed here too."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    print(buf.getvalue(), end="", flush=True)
    return buf.getvalue()


def bench_tools(dev, device_ms, kernel_events, measure):
    """Phase 48 (``chip_smoke.py --bench``, a child alone on the card): the
    port's measurement tools as a user runs them. (i) ``act_tpu_torch.bench``
    at full width (``BENCH_ARGS``, ``BENCH_ENV``): its one JSON line parsed,
    ``mfu`` within ``BENCH_MFU``, the card named, its launches a whole number
    of Stage-II steps, and ``step_flops`` equal to 128 times the count of one step at
    B=1 on the CPU (the count depends on shapes alone and is linear in B),
    counted beside (v).
    (ii) ``act_tpu_torch.bench_suite`` (``SUITE_ARGS``): the rows of the two
    forwards and the three microbenches, each microbench's output against
    its plain version on the suite's input (FPS up to tie swaps, kNN indices
    exactly and distances, the Chamfer loss within ``MICRO_ATOL``).
    (iii) ``act_tpu_torch.bench_sustained`` (``SUSTAINED_ARGS``, the record
    to a temporary file): the loader at 0 and 8 workers and ``run_net`` over
    the tree, ``SUSTAINED_STEPS`` steps of launches. (iv)
    ``graft_entry.entry()`` once at full width: a finite loss through the
    Stage-II kernels. (v) ``graft_entry.dryrun_multichip(DRYRUN_RANKS)``,
    gloo ranks sharing the card, on a thread that waits for the ranks while
    this one counts (i)'s step on the CPU (both untimed): JAX's lines, every
    rank's kernels launched. Prints each part's seconds. Returns (no timing
    rows, errors, launches)."""
    import tempfile

    import torch
    from act_tpu_torch import bench, bench_suite, bench_sustained, graft_entry, profile_step
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.ops.fps import tie_swaps

    t_phase, errs, launches, part_s = time.perf_counter(), {}, {}, {}

    def part_done(name):  # the seconds of each part, printed at the phase's end
        part_s[name] = round(time.perf_counter() - t_phase - sum(part_s.values()), 1)

    # -- (i) the headline
    _backend.reset_launches()
    os.environ.update(BENCH_ENV)  # this child's own environment, as a user sets it
    out = tool_output(bench.main, BENCH_ARGS)
    launches["bench"] = dict(_backend.LAUNCHES)
    (line,) = [ln for ln in out.splitlines() if ln.startswith("{")]
    rec = json.loads(line)
    steps = launches["bench"]["fps"] // STAGE2_PER_STEP["fps"]
    check_launches("bench", launches["bench"], STAGE2_PER_STEP, steps)
    want = 1 + 1 + 3 + 1 + bench.DEVICE_STEPS
    if not BENCH_MFU[0] < (rec["mfu"] or 0) < BENCH_MFU[1] or rec["device"]["platform"] != "gpu" \
            or rec["power_limit"] is None or steps < want:
        fail(f"bench: mfu {rec['mfu']}, device {rec['device']}, power limit "
             f"{rec['power_limit']}, {steps} steps launched (at least {want})")
    torch.cuda.empty_cache()
    part_done("bench")

    # -- (ii) the suite's forwards and microbenches
    _backend.reset_launches()
    out = tool_output(bench_suite.main, SUITE_ARGS)
    launches["bench_suite"] = dict(_backend.LAUNCHES)
    keys = SUITE_ARGS[1].split(",")
    rows = {c[1]: c for c in ([x.strip() for x in ln.split("|")] for ln in out.splitlines()
                              if ln.startswith("| "))}
    for key in keys:  # the host ms of a request (forwards) or a launch (microbenches)
        ms = rows.get(key, [""] * 5)[4 if key in bench_suite.FORWARDS else 3]
        if not ms.replace(".", "", 1).isdigit() or not float(ms) > 0:
            fail(f"bench_suite: no measured row {key!r} in its table")
    for key in ("fps", "knn", "chamfer"):
        _, _, fn, plain = bench_suite.MICROBENCHES[key]
        x = bench_suite.microbench_input(key, dev)
        got, ref = fn(x), plain(x)
        torch.cuda.synchronize()
        if key == "fps":
            swaps = tie_swaps(got, ref)
            ok, err = swaps >= 0, 0.0 if swaps >= 0 else math.inf
        elif key == "knn":
            err = float((got[0] - ref[0]).abs().max())
            ok = torch.equal(got[1], ref[1]) and err <= MICRO_ATOL
        else:
            err = float((got - ref).abs())
            ok = err <= MICRO_ATOL
        errs[f"bench_suite {key}"] = err
        print(f"[bench] suite microbench {key}: against its plain version max |diff| {err} "
              f"(tolerance {MICRO_ATOL}), agree {ok}", flush=True)
        if not ok:
            fail(f"bench_suite {key}: the kernel's output differs from its plain version")
    if not all(launches["bench_suite"][k] > 0 for k in SUITE_KERNELS):
        fail(f"bench_suite: launches {launches['bench_suite']}")
    part_done("suite")

    # -- (iii) the loader and run_net over a small tree
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    try:
        record = os.path.join(tmp, "sustained.json")
        _backend.reset_launches()
        with patched(bench_sustained, RECORD=record):
            tool_output(bench_sustained.main, SUSTAINED_ARGS + ["--root", os.path.join(tmp, "tree")])
        launches["bench_sustained"] = dict(_backend.LAUNCHES)
        with open(record) as f:
            sus = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_launches("bench_sustained", launches["bench_sustained"], STAGE2_PER_STEP,
                   SUSTAINED_STEPS)
    if sorted(sus["loader"]) != ["0", "8"] or not min(sus["loader"].values()) > 0 \
            or not sus["e2e"] > 0 or len(sus["epoch_times_s"]) != 2:
        fail(f"bench_sustained: record {sus}")
    part_done("sustained")

    # -- (iv) the flagship forward
    _backend.reset_launches()
    forward, (model, pts) = graft_entry.entry(dev)
    with torch.no_grad():
        loss = forward(model, pts)
    torch.cuda.synchronize()
    launches["entry"] = dict(_backend.LAUNCHES)
    print(f"[bench] graft_entry.entry(): loss {float(loss)} on {tuple(pts.shape)}, launches "
          f"{launches['entry']}", flush=True)
    check_launches("entry", launches["entry"], STAGE2_PER_STEP, 1)
    if loss.dim() != 0 or not torch.isfinite(loss):
        fail(f"graft_entry.entry(): loss {loss}")
    del model, pts, loss
    torch.cuda.empty_cache()
    part_done("entry")

    # -- (v) the dry run, gloo ranks sharing the card, and beside it (i)'s count on the CPU
    dry = {}

    def dry_run():
        try:
            dry["run"] = graft_entry.dryrun_multichip(DRYRUN_RANKS, dev)
        except Exception as e:  # reported after the count below
            dry["error"] = repr(e)
    ranks = threading.Thread(target=dry_run)
    ranks.start()
    torch.set_num_threads(FLOPS_CPU_THREADS)
    cpu = bench.count_step(profile_step.setup_pretrain("cpu", B=1))
    ranks.join()
    print(f"[bench] step_flops {rec['step_flops']} at B=128 on the card, {cpu} at B=1 on the "
          f"CPU: 128 x {cpu} = {128 * cpu} (equal: {rec['step_flops'] == 128 * cpu}); mfu "
          f"{rec['mfu']}, {rec['value']} clouds/s, step {rec['step_ms']} ms, device "
          f"{rec['device_ms']} ms, idle {rec['idle']}, peak {rec['peak_gib']} GiB", flush=True)
    if rec["step_flops"] != 128 * cpu:
        fail(f"bench: step_flops {rec['step_flops']} is not 128 x the CPU's B=1 count {cpu}")
    if "error" in dry:
        fail(f"dryrun_multichip({DRYRUN_RANKS}): {dry['error']}")
    run = dry["run"]
    for r, n in enumerate(run["launches"]):
        launches[f"dryrun rank {r}"] = n
    if not all(n[k] > 0 for n in run["launches"] for k in n if k != "chamfer_nn_min"):
        fail(f"dryrun_multichip: rank launches {run['launches']}")
    part_done("dry run and CPU count")
    print(f"[bench] dryrun_multichip({DRYRUN_RANKS}): losses "
          f"{ {leg: rec['losses'] for leg, rec in run['legs'].items()} }; rank launches "
          f"{run['launches']}; phase 48 {time.perf_counter() - t_phase:.1f} s ({part_s})",
          flush=True)
    return {}, errs, launches


def finetune_variants(dev):
    """Phase 46 (in phase 42's child, checked and untimed): each config of
    ``VARIANT_CONFIGS`` at full width from its file (the few-shot ones at
    ``VARIANT_FEWSHOT``), with the trainable set its transfer type gives:
    ``run_finetune_steps`` for ``VARIANT_STEPS`` steps on its train loader's
    batches (the kernels launched, the frozen tensors bit-unchanged, the
    head's last layer moved, the losses finite), then one test batch's
    logits through the kernels against the plain path (the eval resample's
    FPS and gather patched into ``engine.serve``, ``group_points`` into
    ``act_tpu_torch.ops``) within LOGIT_ATOL. Returns each run's launches."""
    import itertools

    import torch
    from act_tpu_torch import ops
    from act_tpu_torch.engine import serve
    from act_tpu_torch.engine.runner_finetune import (build_state, finetune_config, loaders,
                                                      predict, run_finetune_steps)
    from act_tpu_torch.ops import _backend

    launches = {}
    for yaml in VARIANT_CONFIGS:
        t0 = time.perf_counter()
        few = "few_shot" in yaml
        cfg = finetune_config(yaml, *VARIANT_FEWSHOT) if few else finetune_config(yaml)
        name = os.path.basename(yaml)[:-len(".yaml")]
        train, test = loaders(cfg, 0, ("train", "val"), device=dev)
        batches = list(itertools.islice(train, VARIANT_STEPS))
        st = build_state(cfg, len(train), 0, dev)
        before = {n: p.detach().clone() for n, p in st.model.named_parameters()}
        _backend.reset_launches()
        run = run_finetune_steps(cfg, VARIANT_STEPS, batches=batches, seed=0, device=dev,
                                 state=st)
        torch.cuda.synchronize()
        launches[f"variant {name} steps"] = dict(_backend.LAUNCHES)
        params = dict(st.model.named_parameters())
        frozen = [n for n, p in params.items() if not p.requires_grad]
        trained = [n for n, p in params.items() if p.requires_grad]
        frozen_same = all(torch.equal(params[n], before[n]) for n in frozen)
        moved = [n for n in trained if not torch.equal(params[n], before[n])]
        head = [n for n in trained if n.startswith("cls_head_finetune.")][-2]  # last weight
        npoints = int(cfg.npoints)
        batch = next(iter(test))
        _backend.reset_launches()
        logits_k, _ = predict(st.model, [batch], npoints, dev)
        launches[f"variant {name} test batch"] = dict(_backend.LAUNCHES)
        with patched(serve, furthest_point_sample=ops.furthest_point_sample_ref,
                     gather_coords=ops.gather_points), \
                patched(ops, group_points=ops.group_points_ref):
            _backend.reset_launches()
            logits_p, _ = predict(st.model, [batch], npoints, dev)
            plain_launched = any(_backend.LAUNCHES.values())
        diff = float(abs(logits_k - logits_p).max())
        agree = bool((logits_k.argmax(-1) == logits_p.argmax(-1)).all())
        unlaunched = [k for k in SERVE_KERNELS
                      if not (launches[f"variant {name} steps"][k]
                              and launches[f"variant {name} test batch"][k])]
        split = ", %d-way %d-shot fold %d" % VARIANT_FEWSHOT if few else ""
        print(f"[variant] {yaml} ({cfg.model.transfer_type}{split}): losses {run.losses}; "
              f"{len(frozen)} frozen tensors bit-unchanged {frozen_same}, "
              f"{len(moved)} of {len(trained)} trained tensors moved (the head's {head}: "
              f"{head in moved}); test batch {tuple(logits_k.shape)} logits through the kernels "
              f"against the plain path: max |diff| {diff} (tolerance {LOGIT_ATOL}), argmax "
              f"agree {agree}; launches {launches[f'variant {name} steps']} (steps), "
              f"{launches[f'variant {name} test batch']} (test batch); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not (all(map(math.isfinite, run.losses)) and frozen_same and head in moved
                and diff <= LOGIT_ATOL and not plain_launched and not unlaunched):
            fail(f"variant {yaml}: a loss not finite, a frozen tensor moved, the head did not, "
                 f"the paths disagree, the plain path launched kernels or a kernel was not "
                 f"launched ({unlaunched})")
        del run, st, before, params
        torch.cuda.empty_cache()
    return launches


def plain_dvae(dev, device_ms, kernel_events, measure):
    """Phase 43, Point-BERT's plain ``DiscreteVAE`` at ``pointbert_dvae.yaml``
    uncut (``chip_smoke.py --plain-dvae``, a child alone on the card): FPS,
    k-smallest (k=32, k=4), the gathers, the Chamfer kernels at the recon and
    validation shapes and the row-gather backward at the DGCNN's rounds
    against their plain versions; phase 12's loss and backward through the
    kernels and the plain versions; ``run_autoencoder_steps`` for
    ``S1_WARM_STEPS`` + ``S1_TIMED_STEPS`` steps from ``S1_START_ITR`` (host
    ms, device ms, idle share, peak GiB), a step rerun from one state
    bit-equal; ``validate`` on ``PD_VAL_CLOUDS`` clouds against the plain
    path. Returns (no timing rows, errors, launches)."""
    import torch
    from act_tpu_torch import ops
    from act_tpu_torch.datasets import synthetic_batch
    from act_tpu_torch.engine.runner_autoencoder import (get_kld_weight, get_temp,
                                                         prepare_model, run_autoencoder_steps,
                                                         validate)
    from act_tpu_torch.engine.serve import load_config
    from act_tpu_torch.engine.train_state import autoencoder_step, step_rngs
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.ops import chamfer as chamfer_mod
    from act_tpu_torch.ops.fps import tie_swaps

    t_phase = time.perf_counter()
    cfg = load_config(PLAIN_DVAE_CONFIG)
    bs, npts = int(cfg.total_bs), int(cfg.dataset.train.others.npoints)
    G, M = int(cfg.model.num_group), int(cfg.model.group_size)
    temp, kldw = get_temp(cfg, S1_START_ITR), get_kld_weight(cfg, S1_START_ITR)
    clouds = torch.from_numpy(synthetic_batch(0, bs, npts)).to(dev)
    errs, launches = {}, {}

    # the kernels at the path's shapes against their plain versions
    g = torch.Generator(device=dev).manual_seed(43)
    with torch.inference_mode():
        kc, rc = ops.furthest_point_sample(clouds, G), ops.furthest_point_sample_ref(clouds, G)
        n_sw = tie_swaps(kc, rc)
        if n_sw < 0 or not torch.equal(kc.sort(-1).values, rc.sort(-1).values):
            fail(f"plain dvae fps ({bs}, {npts}, 3)->{G}: picks differ beyond tie swaps")
        errs["fps plain dvae"] = 0.0
        centers = ops.gather_points(clouds, rc)
        d_grp = ops.square_distance(centers, clouds).reshape(bs * G, npts)
        d_dg = ops.square_distance(centers, centers).reshape(bs * G, G)
        for d, kk in ((d_grp, M), (d_dg, 4)):
            (kv, ki), (rv, ri) = ops.k_smallest(d, kk), ops.k_smallest_ref(d, kk)
            if not (torch.equal(ki, ri) and torch.equal(kv, rv)):
                fail(f"plain dvae k_smallest {tuple(d.shape)} k={kk}: differs")
        errs["k_smallest plain dvae"] = 0.0
        nbr_idx = ops.k_smallest_ref(d_grp, M)[1].reshape(bs, -1)
        for i in (rc, nbr_idx):
            if not torch.equal(ops.gather_coords(clouds, i), ops.gather_points(clouds, i)):
                fail(f"plain dvae gather by {tuple(i.shape)}: not bit-equal")
        errs["gather plain dvae"] = 0.0
        gt = ops.gather_points(clouds, nbr_idx).reshape(bs * G, M, 3)
        pairs = {"recon coarse": ((gt[:, ::4] + 0.01 * torch.randn(
            bs * G, M // 4, 3, generator=g, device=dev)).contiguous(), gt),
            "recon fine": ((gt + 0.01 * torch.randn(gt.shape, generator=g, device=dev)), gt)}
        for tag, (x, y) in pairs.items():
            k, r = chamfer_mod.nn_pair(x, y), ops.chamfer_ref(x, y)
            g1 = torch.randn(x.shape[:2], generator=g, device=dev)
            g2 = torch.randn(y.shape[:2], generator=g, device=dev)
            kb = chamfer_mod.chamfer_bwd(x, y, r[2], r[3], g1, g2)
            rb = ops.chamfer_bwd_ref(*(t.cpu() for t in (x, y, r[2], r[3], g1, g2)))
            if not (all(torch.equal(a, b) for a, b in zip(k, r))
                    and all(torch.equal(a.cpu(), b) for a, b in zip(kb, rb))):
                fail(f"plain dvae chamfer {tag}: kernel and plain version differ")
        x, y = 0.5 * torch.randn(1, G * M, 3, generator=g, device=dev), clouds[:1].contiguous()
        if not all(torch.equal(a, b) for a, b in zip(chamfer_mod.nn_pair_min(x, y),
                                                    ops.chamfer_min_ref(x, y))):
            fail("plain dvae chamfer_nn_min at the validation shape: differs")
        for name in ("chamfer_nn", "chamfer_bwd", "chamfer_nn_min"):
            errs[f"{name} plain dvae"] = 0.0
        dg_idx = ops.graph_feature_idx(centers, centers, 4).reshape(bs, G * 4)
        for c in sorted(set(DGCNN_ROUND_C)):
            check_row_gather(f"plain dVAE DGCNN C={c}",
                             torch.randn(bs, G * 4, c, generator=g, device=dev), dg_idx, G, errs)
    print(f"[plain dvae] kernels against their plain versions at the path's shapes: fps "
          f"({bs}, {npts}, 3)->{G} ({n_sw} tie swaps), k_smallest ({bs * G}, {npts}) k={M} and "
          f"({bs * G}, {G}) k=4, the two gathers, chamfer_nn and chamfer_bwd at "
          f"{[tuple(x.shape) for x, _ in pairs.values()]} x {tuple(gt.shape)}, chamfer_nn_min "
          f"(1, {G * M}) x (1, {npts}): bit-equal (tolerance: exact)", flush=True)

    # the full-width model: phase 12's check
    t0 = time.perf_counter()
    model = prepare_model(cfg, 0, dev)
    n_all = sum(p.numel() for p in model.parameters())
    print(f"[model] {PLAIN_DVAE_CONFIG}: {cfg.model.NAME}, {n_all} params, no teacher, dtype "
          f"{cfg.model.dtype}, built in {time.perf_counter() - t0:.2f} s; synthetic clouds "
          f"{tuple(clouds.shape)}; temperature {temp}, KLD weight {kldw} (iteration "
          f"{S1_START_ITR})", flush=True)
    if getattr(model, "has_teacher", True):
        fail(f"plain dvae: {cfg.model.NAME} built a teacher")
    stage1_paths_agree(model, clouds, temp, kldw, dev, "plain dvae", PD_UPSTREAM_KEYS)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model

    # run_autoencoder_steps, timed
    steps = S1_WARM_STEPS + S1_TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _backend.reset_launches()
    run = run_autoencoder_steps(PLAIN_DVAE_CONFIG, steps, seed=0, start_itr=S1_START_ITR,
                                device=dev)
    launches["run_autoencoder_steps"] = dict(_backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_launches("plain dvae run_autoencoder_steps", launches["run_autoencoder_steps"],
                   STAGE1_PER_STEP, steps)
    after = run.model.state_dict()
    moved_keys = ("codebook", "decoder.final_conv.6.weight", "encoder.first_conv.0.weight",
                  "dgcnn_1.layer5.0.weight", "encoder.first_conv.1.running_mean")
    moved = {k: not torch.equal(after[k], init[k]) for k in moved_keys}
    print(f"[plain dvae] run_autoencoder_steps losses {run.losses}; recon {run.recon}; kld "
          f"{run.kld}; temperature {run.temps[0]:.5f}, KLD weight {run.kld_weights[0]:.5f}; "
          f"launches {launches['run_autoencoder_steps']} in {steps} steps; moved {moved}",
          flush=True)
    if not (all(math.isfinite(x) for x in run.losses + run.recon + run.kld)
            and all(moved.values())):
        fail("plain dvae run_autoencoder_steps: a loss not finite or a tensor did not move")
    med = statistics.median(run.step_ms[S1_WARM_STEPS:])

    def step(i):
        return autoencoder_step(run.model, run.optimizer, lambda s: 1e-6, clouds, i,
                                step_rngs(0, i, dev), temp, kldw, cfg.get("grad_norm_clip"))
    print(f"[time] card: {card_line()}", flush=True)
    busy = busy_line(kernel_events, f"plain dVAE step B={bs}", lambda: step(steps), med, top_n=8)
    print(f"[time] plain dVAE step B={bs}: host median {med:.3f} ms, min "
          f"{min(run.step_ms[S1_WARM_STEPS:]):.3f}, max {max(run.step_ms[S1_WARM_STEPS:]):.3f} "
          f"over {S1_TIMED_STEPS} (after {S1_WARM_STEPS} warm-up); {bs / med * 1e3:.1f} "
          f"clouds/s; device busy {'not measured' if busy is None else f'{busy:.3f} ms'}, idle "
          f"share {'not measured' if busy is None else f'{1 - busy / med:.3f}'}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    same, n_t = rerun_bit_equal(run.model, run.optimizer, lambda: step(steps + 2))
    print(f"[plain dvae] one step (B={bs}, bf16) run twice from one state: every weight, BN "
          f"statistic and Adam moment bit-equal: {same} ({n_t} tensors)", flush=True)
    if not same:
        fail("plain dvae: a step rerun from the same state differs")

    # validate, kernel path against plain path
    val = [torch.from_numpy(c) for c in synthetic_batch(1, PD_VAL_CLOUDS, npts)]
    _backend.reset_launches()
    metrics, per_cloud = validate(run.model, val)
    launches["validate"] = dict(_backend.LAUNCHES)
    check_launches("plain dvae validate", launches["validate"], VALIDATE_PER_CLOUD,
                   PD_VAL_CLOUDS)
    _backend.reset_launches()
    with patched(ops, group_points=ops.group_points_ref,
                 graph_feature_idx=ops.graph_feature_idx_ref), \
            patched(chamfer_mod, nn_pair_min=ops.chamfer_min_ref):
        metrics_p, per_cloud_p = validate(run.model, val)
    if any(_backend.LAUNCHES.values()):
        fail(f"the plain-version validate launched kernels: {_backend.LAUNCHES}")
    worst = max(abs(a - b) / max(abs(b), 1e-12) for ra, rb in zip(per_cloud, per_cloud_p)
                for a, b in zip(ra, rb))
    print(f"[plain dvae] validate on {PD_VAL_CLOUDS} clouds: {metrics.state_dict()} through the "
          f"kernels, {metrics_p.state_dict()} through the plain versions; worst relative "
          f"difference of a cloud's metric {worst} (tolerance {METRIC_RTOL}); launches "
          f"{launches['validate']}", flush=True)
    if not (all(math.isfinite(x) for row in per_cloud for x in row) and worst <= METRIC_RTOL):
        fail("plain dvae validate: metrics not finite or kernel path and plain path disagree")
    print(f"[plain dvae] phase 43 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {}, errs, launches


def plain_dvae_cli(dev, device_ms, kernel_events, measure):
    """Phase 44 (``chip_smoke.py --plain-dvae-cli``, checked and untimed,
    beside phase 37's tracing): ``act_tpu_torch.main_autoencoder.main`` (the
    CLI's entry point, called in this process: as three processes its runs
    took 127 s beside the tracing, NVIDIA H100 80GB HBM3, 700 W) with
    ``--config`` a copy of
    ``pointbert_dvae.yaml`` for one epoch of ``PD_CLI_STEPS`` steps
    (``run_net`` capped, its validation at ``PD_TEST_CLOUDS`` clouds),
    ``--resume``d for a second, then ``--test`` of its ckpt-best on
    ``PD_TEST_CLOUDS`` clouds with ``PD_DUMPS`` ``.txt`` dumps; that checkpoint
    served by ``serve_http.serve`` as ``tokenize`` and ``dvae`` at B=1 and
    ``PD_HTTP_B``, the answers against the plain path on the same weights
    (ids equal, the reconstruction bit-equal, as phase 33 holds them).
    Returns (no timing rows, no errors, the requests' launches)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_plain_dvae_")
    try:
        return {}, {}, _plain_dvae_cli(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _plain_dvae_cli(dev, tmp):
    import contextlib
    import functools
    import io

    import numpy as np
    import torch
    from act_tpu_torch import main_autoencoder, ops, serve_http
    from act_tpu_torch.datasets import synthetic_batch
    from act_tpu_torch.engine import runner_autoencoder as ra
    from act_tpu_torch.engine.serve import (build_recon_fn, build_tokenize_fn, load_config,
                                            load_model)
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.ops.fps import tie_swaps

    t_phase = time.perf_counter()
    with open(os.path.join(ROOT, PLAIN_DVAE_CONFIG)) as f:
        text = f.read().replace("max_epoch: 300", "max_epoch: 1")
    yaml = os.path.join(tmp, "pointbert_dvae.yaml")
    with open(yaml, "w") as f:
        f.write(text.replace("_base_: cfgs/", f"_base_: {ROOT}/cfgs/"))
    tested, test_net = [], ra.test_net  # the test run's metrics
    capped = dict(run_net=functools.partial(ra.run_net, max_steps=PD_CLI_STEPS,
                                            max_val=PD_TEST_CLOUDS),
                  test_net=lambda *a, **k: tested.append(test_net(
                      *a, max_batches=PD_TEST_CLOUDS, max_dumps=PD_DUMPS, **k)))

    def cli(*flags):
        """The CLI's ``main`` in ``tmp`` (the experiment directories are made
        under the working directory); returns what it printed and its seconds."""
        t0, said, cwd = time.perf_counter(), io.StringIO(), os.getcwd()
        os.chdir(tmp)
        try:
            with patched(ra, **capped), contextlib.redirect_stdout(said):
                main_autoencoder.main(["--config", yaml, "--exp_name", "pd", "--device",
                                       str(dev), *flags])
        finally:
            os.chdir(cwd)
        print(said.getvalue(), end="", flush=True)
        return said.getvalue(), time.perf_counter() - t0
    exp = os.path.join(tmp, "work_dirs", "pointbert_dvae", os.path.basename(tmp), "pd")
    _, s_train = cli()
    last = torch.load(os.path.join(exp, "ckpt-last.pth"), map_location="cpu", weights_only=True)
    first = (last["epoch"], last["step"])
    cfg_file = os.path.join(exp, "config.yaml")
    with open(cfg_file) as f:
        saved = f.read()
    with open(cfg_file, "w") as f:
        f.write(saved.replace("max_epoch: 1", "max_epoch: 2"))
    said, s_resume = cli("--resume")
    last = torch.load(os.path.join(exp, "ckpt-last.pth"), map_location="cpu", weights_only=True)
    best = os.path.join(exp, "ckpt-best.pth")
    _, s_test = cli("--test", "--ckpts", best)
    vis = os.path.join(tmp, "work_dirs", "pointbert_dvae", os.path.basename(tmp), "test_pd",
                       "vis")
    dumps = sorted(os.listdir(vis)) if os.path.isdir(vis) else []
    cfg = load_config(PLAIN_DVAE_CONFIG)
    npts, G, M = int(cfg.npoints), int(cfg.model.num_group), int(cfg.model.group_size)
    shapes = sorted({np.loadtxt(os.path.join(vis, d)).shape for d in dumps})
    print(f"[plain dvae cli] main_autoencoder: {PD_CLI_STEPS} steps ({s_train:.1f} s), "
          f"ckpt-last at (epoch, step) {first}; --resume ({s_resume:.1f} s): at "
          f"{(last['epoch'], last['step'])}; --test of ckpt-best ({s_test:.1f} s): "
          f"{tested[0].state_dict() if tested else None}, {len(dumps)} dumps of shapes {shapes}",
          flush=True)
    wrong = {"the first run's ckpt-last": first != (0, PD_CLI_STEPS),
             "the resumed run's ckpt-last": (last["epoch"], last["step"]) != (1, 2 * PD_CLI_STEPS),
             "no [RESUME] line": "[RESUME] resumed at epoch 1" not in said,
             "no finite test metrics": not (tested and all(
                 math.isfinite(v) for v in tested[0].state_dict().values())),
             "the dumps": (len(dumps) != 2 * PD_DUMPS
                           or shapes != sorted({(G * M, 3), (npts, 3)})),
             "a teacher in the checkpoint": any(k.startswith("visual_embed")
                                                for k in last["base_model"])}
    if any(wrong.values()):
        fail(f"plain dvae CLI: {[k for k, v in wrong.items() if v]}")

    # the ckpt-best served over HTTP, against the plain path on the same weights
    model = load_model(cfg, best, device=dev)
    fns = {"tokenize": build_tokenize_fn(model, npts), "dvae": build_recon_fn(model, npts)}
    config_path = os.path.join(ROOT, PLAIN_DVAE_CONFIG)
    clouds = torch.from_numpy(synthetic_batch(3, PD_HTTP_B, npts))
    launches = {}
    for kind, fn in fns.items():
        server = serve_http.serve(config_path, best, "127.0.0.1", 0, device=dev,
                                  kind=None if kind == "tokenize" else kind)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/predict"
            for b in (1, PD_HTTP_B):
                x = clouds[:b]
                _backend.reset_launches()
                with urllib.request.urlopen(urllib.request.Request(
                        url, data=json.dumps({"points": x.tolist()}).encode()),
                        timeout=300) as resp:
                    code, answer = resp.status, json.loads(resp.read())
                launches[f"http {kind} B={b}"] = dict(_backend.LAUNCHES)
                key = "tokens" if kind == "tokenize" else "recon"
                got = torch.tensor(answer[key], dtype=torch.int32 if kind == "tokenize"
                                   else torch.float32)
                with patched(ops, group_points=ops.group_points_ref,
                             graph_feature_idx=ops.graph_feature_idx_ref):
                    want = fn(x.to(dev)).cpu()
                xd = x.to(dev)
                n_sw = tie_swaps(ops.furthest_point_sample(xd, G),
                                 ops.furthest_point_sample_ref(xd, G))
                if n_sw == 0:
                    same = torch.equal(got, want)
                elif kind == "tokenize":
                    same = torch.equal(got.sort(-1).values, want.sort(-1).values)
                else:
                    same = torch.equal(got.reshape(b, G, M, 3).sort(1).values,
                                       want.reshape(b, G, M, 3).sort(1).values)
                per = TOKENIZE_PER_REQUEST if kind == "tokenize" else RECON_PER_REQUEST
                print(f"[plain dvae cli] {kind} over HTTP B={b}: {code}, {tuple(got.shape)} "
                      f"against the plain path on ckpt-best: {'equal' if same else 'DIFFERENT'} "
                      f"(tolerance: exact; {n_sw} FPS tie swaps); launches "
                      f"{launches[f'http {kind} B={b}']}", flush=True)
                if code != 200 or not same:
                    fail(f"plain dvae {kind} over HTTP B={b}: {code}, the plain path differs")
                check_launches(f"plain dvae http {kind} B={b}", launches[f"http {kind} B={b}"],
                               per, 1)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    print(f"[plain dvae cli] phase 44 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def flops(dev, device_ms, kernel_events, measure):
    """Phase 45 (``chip_smoke.py --flops``, checked and untimed, beside phase
    37's tracing): ``act_tpu_torch.get_flops`` on every shipped model YAML
    (``FLOPS_DIRS``): the model built once on the card and counted there
    (the kernels), then moved to the CPU and counted again (the plain
    versions); the two counts equal exactly (a count depends on shapes alone,
    so a difference is a formula that fired on one path only), and the
    kernels the card's forward launched are the kernels it counted. Prints
    each config's four lines. Returns (no timing rows, no errors, each
    config's launches)."""
    import glob

    import torch
    from act_tpu_torch import get_flops
    from act_tpu_torch.ops import _backend

    t_phase = time.perf_counter()
    torch.set_num_threads(FLOPS_CPU_THREADS)
    paths = sorted(p for d in FLOPS_DIRS
                   for p in glob.glob(os.path.join("cfgs", d, "*.yaml")))
    if len(paths) != FLOPS_CONFIGS:
        fail(f"get_flops: {len(paths)} model YAMLs under {FLOPS_DIRS}, not {FLOPS_CONFIGS}")
    launches = {}
    for path in paths:
        model = get_flops.build(path, device=dev)
        _backend.reset_launches()
        card = get_flops.count(model)
        torch.cuda.synchronize()
        launches[path] = dict(_backend.LAUNCHES)
        cpu = get_flops.count(model.cpu())
        launched = {k for k, v in launches[path].items() if v}
        print(f"[flops] {path}: " + "; ".join(get_flops.report(card))
              + f"; aten {card.aten_flops}, kernels {card.kernel_flops}; launches "
              f"{ {k: v for k, v in launches[path].items() if v} }", flush=True)
        if not (card == cpu and launched == set(card.kernel_flops)):
            fail(f"get_flops {path}: the card's count {card} differs from the CPU's {cpu}, or "
                 f"the kernels launched {sorted(launched)} are not the kernels counted "
                 f"{sorted(card.kernel_flops)}")
        del model
        torch.cuda.empty_cache()
    for path in ("cfgs/finetune_classification/few_shot/fewshot_modelnet.yaml",
                 TSNE_CONFIG):
        try:
            get_flops.build(path, device=dev)
            fail(f"get_flops {path}: no error")
        except ValueError as e:
            print(f"[flops] {path}: ValueError: {e}", flush=True)
    print(f"[flops] phase 45 {time.perf_counter() - t_phase:.1f} s ({len(paths)} configs, each "
          f"counted on the card and on the CPU)", flush=True)
    return {}, {}, launches


def _extract_both(model, batches, npoints, runner_tsne):
    """``extract_features`` with logits through the kernels and through the
    plain versions (patched into ``act_tpu_torch.ops``), each run's
    launches, and the FPS tie swaps between the two paths' resample and
    group-center picks."""
    import torch
    from act_tpu_torch import ops
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.ops.fps import tie_swaps

    torch.cuda.synchronize()
    _backend.reset_launches()
    got = runner_tsne.extract_features(model, batches, npoints, with_logits=True)
    torch.cuda.synchronize()
    launches = dict(_backend.LAUNCHES)
    with patched(ops, furthest_point_sample=ops.furthest_point_sample_ref,
                 gather_coords=ops.gather_points, group_points=ops.group_points_ref):
        _backend.reset_launches()
        want = runner_tsne.extract_features(model, batches, npoints, with_logits=True)
        if any(_backend.LAUNCHES.values()):
            fail(f"t-SNE plain path launched kernels: {dict(_backend.LAUNCHES)}")
    swaps = 0
    with torch.inference_mode():
        for b in batches:
            pts = torch.as_tensor(b[2][0]).to(model.cls_token.device)
            r = ops.furthest_point_sample_ref(pts, npoints)
            rs = ops.gather_points(pts, r)
            for k, want_idx in ((ops.furthest_point_sample(pts, npoints), r),
                                (ops.furthest_point_sample(rs, model.num_group),
                                 ops.furthest_point_sample_ref(rs, model.num_group))):
                n = tie_swaps(k, want_idx)
                if n < 0:
                    fail("t-SNE FPS picks differ from the plain version beyond tie swaps")
                swaps += n
    return got, want, launches, swaps


def tsne(dev, device_ms, kernel_events, measure):
    """Phase 36, t-SNE at ``tsne_scan_hardest.yaml`` (two 384 x 12
    PointTransformers, G=128 x M=32, 2048 points, 15 classes, B=32, seeded
    weights, the synthetic ScanObjectNN test clouds): 36a, both models'
    ``extract_features`` (the FPS resample 2048 -> 2048, ``extract_feature``,
    the finetuned logits) through the kernels and through the plain versions,
    bit-equal unless FPS tie swaps reorder the groups, launches a batch
    counted, the resample's launch shapes timed; 36b, ``tsne_net`` with 2
    batches and 2 vote rounds, on those batches labelled with the seeded
    finetuned model's own predictions, so that every cloud counts as correct
    and both embeddings and their ``.npz`` files are made; 36c,
    ``utils/tsne.embed`` on the card at N = ``TSNE_N`` features (the size of
    ScanObjectNN hardest's test split, from synthetic clouds), timed, run
    twice (the same embedding), and at the first ``TSNE_REF_N`` of them on
    the card and on the CPU, the final KLs within ``TSNE_KL_RTOL`` (the CPU
    run in the parent, when it set ``TSNE_REF_ENV``). Returns (timing rows
    by kernel, errors, launches of each run)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tsne_")
    try:
        return _tsne(dev, device_ms, kernel_events, measure, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _tsne(dev, device_ms, kernel_events, measure, tmp):
    import numpy as np
    import torch
    from act_tpu_torch import ops
    from act_tpu_torch.datasets.synthetic import synthetic_cloud
    from act_tpu_torch.engine import builder, runner_tsne
    from act_tpu_torch.engine.serve import load_config
    from act_tpu_torch.ops import _backend, work
    from act_tpu_torch.utils import tsne as tsne_lib

    t_phase = time.perf_counter()
    cfg = load_config(TSNE_CONFIG)
    npoints, bs = int(cfg.npoints), int(cfg.total_bs)
    G, M = int(cfg.model_finetuned.num_group), int(cfg.model_finetuned.group_size)
    cfg.dataset.test.others.bs = bs
    _, loader = builder.dataset_builder(cfg.dataset.test, 0)
    try:
        batches = [b for _, b in zip(range(TSNE_BATCHES), loader)]
    finally:
        loader.close()
    errs, launches = {}, {}
    model_p = runner_tsne._build_and_load(cfg.model_pretrained, None, npoints, 1, dev)
    model_f = runner_tsne._build_and_load(cfg.model_finetuned, None, npoints, 0, dev)
    print(f"[tsne] {TSNE_CONFIG}: two {sum(p.numel() for p in model_f.parameters())}-parameter "
          f"models, {len(batches)} test batches of {bs} x {npoints} points", flush=True)

    # -- 36a. features and logits, kernels against the plain path
    logits = {}
    for tag, model in (("pretrained", model_p), ("finetuned", model_f)):
        got, want, n, swaps = _extract_both(model, batches, npoints, runner_tsne)
        logits[tag] = got[1]
        launches[f"extract {tag}"] = n
        check_launches(f"tsne extract_features {tag} (with logits)", n, TSNE_PER_BATCH,
                       len(batches))
        same = all(np.array_equal(a, b) for a, b in zip(got, want))
        diff = max(float(np.abs(a - b).max()) for a, b in zip(got[:2], want[:2]))
        errs[f"fps tsne {tag}"] = errs[f"gather tsne {tag}"] = errs[f"k_smallest tsne {tag}"] = diff
        print(f"[check] tsne {tag}: features {got[0].shape} and logits {got[1].shape} through "
              f"the kernels vs the plain path: bit-equal {same}, max |diff| {diff}, FPS tie "
              f"swaps {swaps}; launches {n} ({TSNE_PER_BATCH} a batch)", flush=True)
        if not np.isfinite(got[0]).all() or not np.isfinite(got[1]).all():
            fail(f"tsne {tag}: features or logits not finite")
        if not (same or (swaps > 0 and diff <= FEAT_ATOL)):
            fail(f"tsne {tag}: the kernel path differs from the plain path (tie swaps {swaps})")
    with torch.inference_mode():
        clouds = torch.as_tensor(batches[0][2][0]).to(dev).contiguous()
        rs = ops.gather_points(clouds, ops.furthest_point_sample_ref(clouds, npoints))
        idx = ops.furthest_point_sample(clouds, npoints)
        rows = {"fps": [measure(f"({bs}, {npoints}, 3)->{npoints} (t-SNE resample)",
                                lambda: ops.furthest_point_sample(clouds, npoints),
                                lambda: ops.furthest_point_sample_ref(clouds, npoints), None,
                                20, 1, bound_ms(clouds.numel() * 4 + bs * npoints * 4,
                                                work.fps(bs, npoints, npoints)), n=3),
                        measure(f"({bs}, {npoints}, 3)->{G} (t-SNE groups)",
                                lambda: ops.furthest_point_sample(rs, G),
                                lambda: ops.furthest_point_sample_ref(rs, G), None, 50, 3,
                                bound_ms(rs.numel() * 4 + bs * G * 4,
                                         work.fps(bs, npoints, G)), n=2)],
                "gather": [measure(f"{tuple(clouds.shape)} by {tuple(idx.shape)} (t-SNE "
                                   f"resample), {distinct_rows(idx)} rows read",
                                   lambda: ops.gather_coords(clouds, idx),
                                   lambda: ops.gather_points(clouds, idx),
                                   lambda: torch.gather(clouds, 1, idx.long()[..., None].expand(
                                       -1, -1, 3)), 200, 200,
                                   bound_ms(distinct_rows(idx) * 12 + idx.numel() * 16), n=1)]}
    print_times("tsne ", rows)

    # -- 36b. tsne_net: 2 batches, both models, 2 vote rounds. Seeded weights
    # classify too few clouds correctly to embed any (OA 7.8 %), so the
    # batches carry the predictions of the finetuned model that tsne_net
    # builds (the same seed) as their labels: every cloud is embedded.
    preds = logits["finetuned"].argmax(-1)
    relabelled, i = [], 0
    for b in batches:
        lab = torch.as_tensor(b[2][1])
        relabelled.append((b[0], b[1], (b[2][0], torch.as_tensor(
            preds[i:i + len(lab)], dtype=lab.dtype).reshape(lab.shape))))
        i += len(lab)
    args = type("Args", (), dict(experiment_path=tmp, seed=0, ckpts=None, device=dev,
                                 log_name=None))()
    torch.cuda.synchronize()
    _backend.reset_launches()
    t0 = time.perf_counter()
    with patched(builder, dataset_builder=lambda node, seed: (
            None, type("Loader", (), dict(__iter__=lambda self: iter(relabelled),
                                          close=lambda self: None))())):
        emb_p, emb_f = runner_tsne.tsne_net(args, cfg, max_batches=TSNE_BATCHES)
    torch.cuda.synchronize()
    launches["tsne_net"] = dict(_backend.LAUNCHES)
    print(f"[tsne] tsne_net ({TSNE_BATCHES} batches labelled with the finetuned model's "
          f"predictions, 2 vote rounds): {time.perf_counter() - t0:.2f} s, launches "
          f"{launches['tsne_net']}, embedded "
          f"{'none' if emb_p is None else (emb_p.shape, emb_f.shape)}", flush=True)
    for k in SERVE_KERNELS:
        if launches["tsne_net"][k] <= 0:
            fail(f"tsne_net launched no {k} kernel")
    for name, emb in (("pretrained", emb_p), ("finetuned", emb_f)):
        path = os.path.join(tmp, f"tsne_{name}.npz")
        if emb is None or emb.shape != (len(preds), 2) or not np.isfinite(emb).all():
            fail(f"tsne_net {name}: no finite embedding of all {len(preds)} clouds")
        saved = np.load(path)
        if not (np.array_equal(saved["embedding"], emb)
                and np.array_equal(saved["labels"], preds)):
            fail(f"tsne_net {name}: {path} differs from the embedding returned")
        print(f"[tsne] {path}: embedding {saved['embedding'].shape}, KL "
              f"{float(saved['kl']):.6f} after {int(saved['n_iter']) + 1} iterations",
              flush=True)

    # -- 36c. the card's t-SNE at N = TSNE_N features
    t0 = time.perf_counter()
    cl = [synthetic_cloud(i, npoints, 15) for i in range(TSNE_N)]
    sets = [(torch.from_numpy(np.stack([c[0] for c in cl[i:i + bs]])),
             torch.tensor([c[1] for c in cl[i:i + bs]])) for i in range(0, TSNE_N, bs)]
    _backend.reset_launches()
    feats, labels = runner_tsne.extract_features(model_p, sets, npoints)
    launches["extract N"] = dict(_backend.LAUNCHES)
    print(f"[tsne] features of {TSNE_N} synthetic clouds: {feats.shape} in "
          f"{time.perf_counter() - t0:.2f} s, launches {launches['extract N']}", flush=True)
    embs, times = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embs.append(tsne_lib.embed(feats, dev))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    e = embs[0]
    same = np.array_equal(embs[0].y, embs[1].y)
    print(f"[time] t-SNE N={TSNE_N} (perplexity {e.perplexity}, {e.n_iter + 1} iterations) on "
          f"the card: {times[0]:.3f} s, again {times[1]:.3f} s; final KL {e.kl:.6f} (again: "
          f"same embedding {same})", flush=True)
    if not (np.isfinite(e.y).all() and same):
        fail("t-SNE on the card: not finite or not repeatable")
    small = tsne_lib.embed(feats[:TSNE_REF_N], dev)
    print(f"[tsne] t-SNE N={TSNE_REF_N} (the first features) on the card: final KL "
          f"{small.kl:.6f}", flush=True)
    if not np.isfinite(small.y).all():
        fail(f"t-SNE on the card at N={TSNE_REF_N}: not finite")
    ref = os.environ.get(TSNE_REF_ENV)
    if ref:  # the CPU run of the same features: the parent's, beside phase 37's tracing
        np.savez(ref, feats=feats[:TSNE_REF_N], kl=small.kl)
    else:
        tsne_cpu_check(feats[:TSNE_REF_N], small.kl)
    print(f"[tsne] phase 36 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows, errs, launches


def tsne_cpu_check(feats, card_kl) -> None:
    """Phase 36's reference: the t-SNE of ``feats`` on the CPU, its final KL
    within ``TSNE_KL_RTOL`` of the card's ``card_kl`` (fails otherwise)."""
    from act_tpu_torch.utils import tsne as tsne_lib
    t0 = time.perf_counter()
    on_cpu = tsne_lib.embed(feats, "cpu")
    cpu_s = time.perf_counter() - t0
    rel = abs(card_kl - on_cpu.kl) / on_cpu.kl
    print(f"[time] t-SNE N={len(feats)} on the CPU: {cpu_s:.1f} s, KL {on_cpu.kl:.6f} "
          f"({on_cpu.n_iter + 1} iterations); the card's {card_kl:.6f}: |KL diff| / CPU KL "
          f"{rel:.5f} (tolerance {TSNE_KL_RTOL})", flush=True)
    if not rel <= TSNE_KL_RTOL:
        fail("t-SNE on the card: its KL is off the CPU run's")


def export(dev, device_ms, kernel_events, measure):
    """Phase 37, the serving artifacts: each of the five kinds of
    ``engine/export.py`` exported on the card from the configs this script
    serves (the full-width ModelNet classifier on 8192-point clouds; the
    Stage-II model's features and the Stage-I dVAE's tokens and
    reconstruction on 1024-point clouds, part and semantic segmentation on
    2048-point clouds, each at its widths with its transformers cut,
    ``cut_depth`` and ``CUT_SEG_WIDTHS``; seeded weights) with a symbolic batch (the
    reconstruction at B=``EXPORT_B``: a symbolic batch raises, checked),
    saved, and reloaded in a fresh process that imports no
    model module (``chip_smoke.py --artifacts``): there each artifact's
    outputs at B=1 and ``EXPORT_B`` (a fixed batch: its own), its launches,
    the kernel names in the profile of a call, its request times and one
    answer of its HTTP server (the first's made by ``serve_http``'s
    ``src``); here the outputs are held bit-equal to
    the direct serving function's (token ids exactly) and the request times
    compared. Returns (timing rows by kernel, errors, launches of each
    artifact's calls)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        return _export_phase(dev, kernel_events, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _export_phase(dev, kernel_events, tmp):
    import torch
    from act_tpu_torch.engine import export as ex
    from act_tpu_torch.engine.runner_pretrain import build_pretrain_model
    from act_tpu_torch.engine.serve import (build_features_fn, build_infer_fn, build_recon_fn,
                                            build_tokenize_fn, features_npoints, load_config,
                                            load_model, load_seg_model)

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(37)
    cls_cfg = load_config(CONFIG)
    pre_cfg, ae_cfg = (cut_depth(load_config(c)) for c in (PRETRAIN_CONFIG, AUTOENCODER_CONFIG))
    npts_f = features_npoints(pre_cfg)
    models = {"classifier": load_model(cls_cfg, seed=0, device=dev),
              "features": build_pretrain_model(pre_cfg.model, 0).to(dev).eval(),
              "tokenize": load_model(ae_cfg, seed=0, device=dev)}
    models["dvae"] = models["tokenize"]
    models.update({t: load_seg_model(t, seed=0, device=dev, widths=CUT_SEG_WIDTHS)
                   for t in ("partseg", "semseg")})
    direct = {
        "classifier": build_infer_fn(models["classifier"], int(cls_cfg.npoints)),
        "features": build_features_fn(models["features"], npts_f),
        "tokenize": build_tokenize_fn(models["tokenize"], int(ae_cfg.npoints)),
        "dvae": build_recon_fn(models["dvae"], int(ae_cfg.npoints)),
        "partseg": build_infer_fn(models["partseg"], SEG_NPOINT, with_fps=False),
        "semseg": build_infer_fn(models["semseg"], SEG_NPOINT, with_fps=False),
    }
    pth_mib = {}  # each model's state dict saved as a .pth, against its artifacts' size
    for kind, model in models.items():
        path = os.path.join(tmp, f"{kind}.pth")
        torch.save(model.state_dict(), path)
        pth_mib[kind] = os.path.getsize(path) / 2 ** 20
        os.remove(path)
    n_in = {"classifier": N_IN, "features": npts_f, "tokenize": int(ae_cfg.npoints),
            "dvae": int(ae_cfg.npoints), "partseg": SEG_NPOINT, "semseg": SEG_NPOINT}
    makers = {
        "classifier": lambda b: ex.export_classifier(cls_cfg, batch=b, n_in=N_IN, device=dev),
        "features": lambda b: ex.export_features(pre_cfg, batch=b, device=dev),
        "tokenize": lambda b: ex.export_dvae_tokenize(ae_cfg, batch=b, device=dev),
        "dvae": lambda b: ex.export_dvae_recon(ae_cfg, batch=b, device=dev),
        "partseg": lambda b: ex.export_segmentation("partseg", SEG_NPOINT, batch=b, device=dev,
                                                    widths=CUT_SEG_WIDTHS),
        "semseg": lambda b: ex.export_segmentation("semseg", SEG_NPOINT, batch=b, device=dev,
                                                   widths=CUT_SEG_WIDTHS),
    }
    # the full-depth classifier last: the first artifact's server (``serve(src=)``) loads
    # its artifact once more
    batches = {k: (None,) for k in makers if k != "classifier"}
    batches["dvae"] = (EXPORT_B,)
    batches["classifier"] = (None,)
    try:
        makers["dvae"](None)
        fail("export_dvae_recon with a symbolic batch did not raise")
    except ValueError as e:
        print(f"[export] dvae with a symbolic batch raises ValueError: {e}", flush=True)
    inputs = {}
    for kind, n in n_in.items():
        x = [torch.randn(EXPORT_B, n, 3, generator=gen)]
        if kind == "partseg":
            x.append(torch.eye(16)[torch.arange(EXPORT_B) % 16])
        inputs[kind] = x
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    spec, sizes = [], {}
    beside = " (beside the parent's checked work)" if os.environ.get(QUIET_ENV) else ""
    for kind, bs in batches.items():
        for b in bs:
            name = f"{kind}-{'sym' if b is None else b}"
            path = os.path.join(tmp, f"{name}.pt2")
            t0 = time.perf_counter()
            exported = makers[kind](b)
            t_export = time.perf_counter() - t0
            t0 = time.perf_counter()
            side = ex.save_exported(exported, path)
            t_save = time.perf_counter() - t0
            sizes[name] = side["bytes"] / 2 ** 20
            print(f"[export] {name}: traced in {t_export:.1f} s, saved in {t_save:.1f} s{beside}, "
                  f"{sizes[name]:.1f} MiB (the model's .pth {pth_mib[kind]:.1f} MiB), inputs "
                  f"{side['in_shapes']} -> {side['out_shape']} {side['out_dtype']}, kernel ops "
                  f"{side['needs_ops']}", flush=True)
            if not side["needs_ops"]:
                fail(f"export {name}: the card's artifact holds no act_tpu_torch kernel op")
            spec.append({"name": name, "kind": kind, "path": path,
                         "sizes": [1, EXPORT_B] if b is None else [b]})
            del exported
    with open(os.path.join(tmp, "spec.json"), "w") as f:
        json.dump(spec, f)
    wait_for_quiet()
    out = os.path.join(tmp, "loaded.json")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--artifacts", tmp, out],
                          cwd=ROOT, timeout=900)
    if proc.returncode != 0:
        fail(f"the artifacts' loader process failed (exit {proc.returncode})")
    with open(out) as f:
        loaded = json.load(f)
    outs = torch.load(os.path.join(tmp, "outputs.pt"))
    errs, launches = {}, {}
    for item in spec:
        name, kind, res = item["name"], item["kind"], loaded[item["name"]]
        for b in item["sizes"]:
            x = [t[:b].to(dev) for t in inputs[kind]]
            want = direct[kind](*x)
            got = outs[f"{name} B={b}"].to(dev)
            same = got.dtype == want.dtype and torch.equal(got, want)
            diff = (got.float() - want.float()).abs().max().item()
            rel = diff / max(want.float().abs().max().item(), 1e-30)
            for k in SERVE_KERNELS:
                errs[f"{k} export {name} B={b}"] = diff
            print(f"[check] export {name} B={b}: artifact vs direct call "
                  f"{'bit-equal' if same else f'max |diff| {diff:.3g}, relative {rel:.3g}'}",
                  flush=True)
            if not same and (kind == "tokenize" or rel > EXPORT_RTOL):
                fail(f"export {name} B={b}: the artifact differs from the direct call "
                     f"(graph ops {res['ops']})")
        launches[name] = res["launches"]
        for k in SERVE_KERNELS:
            if res["launches"][k] <= 0 or not res["kernels"].get(k):
                fail(f"export {name}: kernel {k} not launched or not in the call's profile "
                     f"({res['launches']}, {res['kernels']})")
        b = item["sizes"][-1]
        x = [t[:b].to(dev) for t in inputs[kind]]
        direct_ms = statistics.median(request_ms(lambda: direct[kind](*x), EXPORT_ITERS))
        print(f"[time] export {name} B={b}: artifact request median {res['ms']:.3f} ms, device "
              f"busy {res['busy_ms']:.3f} ms (fresh process, load {res['load_s']:.2f} s); direct "
              f"call {direct_ms:.3f} ms; ", flush=True)
        busy_line(kernel_events, f"export {name} B={b}, the direct call", lambda: direct[kind](*x),
                  direct_ms, iters=2)
        print(f"[export] {name}: "
              f"{sizes[name]:.1f} MiB; kernels in the profile {res['kernels']}; launches "
              f"{res['launches']}; its HTTP server {res['http']}", flush=True)
    print(f"[export] phase 37 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {}, errs, launches


def wait_for(path: str, what: str, timeout=900) -> float:
    """Wait until ``path`` exists (``what`` has happened); fails after
    ``timeout`` s or when the process that started this one has ended.
    Returns the seconds waited."""
    t0, parent = time.perf_counter(), os.getppid()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout or os.getppid() != parent:
            fail(f"gave up waiting for {what}")
        time.sleep(0.2)
    return time.perf_counter() - t0


def wait_for_quiet() -> None:
    """Wait until the file of ``QUIET_ENV`` exists (when it is set): the
    parent's work beside this phase has ended."""
    quiet = os.environ.get(QUIET_ENV)
    if quiet:
        waited = wait_for(quiet, "the work beside phase 37's tracing")
        print(f"[export] traced and saved; waited {waited:.1f} s for the work beside the "
              f"tracing to end before the timed requests", flush=True)


def artifacts_child(tmp: str, out: str) -> None:
    """The fresh process of phase 37: every artifact of ``tmp/spec.json``
    through ``load_exported`` (which imports ``act_tpu_torch.ops`` and no
    model module, checked at the end), its outputs on ``tmp/inputs.pt`` at
    each batch (to ``tmp/outputs.pt``), its kernel launches, the kernels in
    the profile of one call, its request median, and one answer of its
    HTTP server held to the call (the first artifact's server made by
    ``serve_http.serve(src=...)``)."""
    import torch
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from act_tpu_torch import serve_http
    from act_tpu_torch.engine.export import load_exported
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.profiling import kernel_events

    dev = _backend.resolve_device("cuda")
    with open(os.path.join(tmp, "spec.json")) as f:
        spec = json.load(f)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"))
    names = {"fps": "fps_kernel", "k_smallest": "ksmallest", "gather": "gather_"}
    res, outs = {}, {}
    for item in spec:
        t0 = time.perf_counter()
        fn = load_exported(item["path"], device=dev)
        load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        _backend.reset_launches()
        for b in item["sizes"]:
            x = [t[:b].to(dev) for t in inputs[item["kind"]]]
            outs[f"{item['name']} B={b}"] = fn(*x).cpu()
        torch.cuda.synchronize()
        launches = dict(_backend.LAUNCHES)
        for _ in range(3):  # a window may lose its first records (profiling.py)
            ev = kernel_events(lambda: fn(*x), 2)
            kernels = {k: sorted({e.name[:40] for e in ev if v in e.name})
                       for k, v in names.items()}
            if all(kernels.values()):
                break
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3 / 2
        ms = statistics.median(request_ms(lambda: fn(*x), EXPORT_ITERS))
        # the first artifact through ``serve(src=...)``, which loads it again; the
        # others through the same server on the program loaded above
        server = (serve_http.serve(src=item["path"], port=0, device=dev) if item is spec[0]
                  else serve_http.make_server(fn, dict(fn.meta), "127.0.0.1", 0))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            hb = 2 if len(item["sizes"]) > 1 else item["sizes"][0]  # a symbolic batch: 2
            body = {"points": inputs[item["kind"]][0][:hb].tolist()}
            if len(x) > 1:
                body["cls_label"] = x[1][:len(body["points"])].argmax(-1).tolist()
            url = f"http://127.0.0.1:{server.server_address[1]}/predict"
            with urllib.request.urlopen(urllib.request.Request(
                    url, data=json.dumps(body).encode()), timeout=300) as r:
                code, answer = r.status, json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        pts = torch.tensor(body["points"]).to(dev)
        extra = (torch.eye(16).to(dev)[torch.tensor(body["cls_label"])],) if len(x) > 1 else ()
        want = fn(pts, *extra).cpu()
        key = {"classifier": "logits", "features": "features", "tokenize": "tokens",
               "dvae": "recon"}.get(item["kind"], "labels")
        got = torch.tensor(answer[key])
        want = want.argmax(-1) if key == "labels" else want.to(got.dtype)
        http = f"{code}, {'equal to the call' if torch.equal(got, want) else 'DIFFERS'}"
        if code != 200 or not torch.equal(got, want):
            fail(f"the HTTP server of {item['name']}: {http}")
        graph_ops = sorted({str(n.target) for n in fn.exported.graph.nodes
                            if n.op == "call_function"})
        res[item["name"]] = dict(load_s=load_s, launches=launches, kernels=kernels, ms=ms,
                                 busy_ms=busy, http=http, ops=graph_ops)
    models = sorted(m for m in sys.modules if m.startswith(
        ("act_tpu_torch.models", "act_tpu_torch.engine.serve", "act_tpu_torch.engine.runner")))
    if models:
        fail(f"loading the artifacts imported model modules: {models}")
    torch.save(outs, os.path.join(tmp, "outputs.pt"))
    with open(out, "w") as f:
        json.dump(res, f)


# -- 38. data parallelism and preemption (``chip_smoke.py --ddp OUT``) --------------
DDP_STEPS = 3  # steps of each model held across the legs (Stage I: DDP_S1_STEPS)
DDP_S1_STEPS = 2
DDP_S1_ITR = 60000  # Stage I's anneal iteration: the KLD weight counts
DDP_PROBE_BS = 256  # the probe's global batch (2 x total_bs)
# leg (b) against the one-rank run on the same global batches, both in f32: the
# losses, and for the weights' change over the steps, the BN running statistics
# and Adam's first moments the norm of the difference over all tensors of the
# kind against the one-rank norm, within DDP_RTOL; the probe's features within
# FEAT_ATOL (bf16 at another batch). Stage I's DGCNN kNN and Chamfer choices
# flip at near ties under rounding: on a small model one CPU step at 1 and at 4
# threads differed by 1e-3 of the moments' norm, one over 2 ranks by 2-4 %
DDP_RTOL = {"ft": 2e-2, "s2": 2e-2, "s1": 0.1, "ps": 2e-2, "ss": 2e-2, "pb": 2e-2}
# the kinds held to DDP_RTOL in leg (b). Stage I's weights' change is read, not held:
# AdamW's first steps move each weight by about lr whatever its gradient's size, so
# the weights whose gradient is at rounding level (its DGCNN's) move either way at
# the other summation order of two ranks (0.189 on the H100); leg (a) holds Stage I
# bit-equal to the run without a group (its row gathers' backward sums in a fixed order)
DDP_HELD = {"ft": ("dw", "bn", "m"), "s2": ("dw", "bn", "m"), "s1": ("bn", "m"),
            "ps": ("dw", "bn", "m"), "ss": ("dw", "bn", "m"), "pb": ("dw", "bn", "m", "k", "q")}
# the gradient reduction gone wrong that leg (b)'s f32 finetune steps also take,
# and whether the check above must reject it: none (each rank steps on its own
# half of the batch)
DDP_FAULTS = {"missing": True}
# leg (b)'s finetune steps in the shipped bf16: each measure of the 2-rank bf16
# run against the one-rank f32 run within DDP_BF16_FACTOR x the same measure of
# the one-rank bf16 run (bf16 rounding alone, at the same batches)
DDP_BF16_FACTOR = 2.0
DDP_PER_STEP = {"ft": FINETUNE_PER_STEP, "ft16": FINETUNE_PER_STEP, "s2": STAGE2_PER_STEP,
                "s1": STAGE1_PER_STEP, "ps": SEG_PER_STEP, "ss": SEG_PER_STEP,
                "pb": POINTBERT_PER_STEP, "pbq": POINTBERT_PER_STEP}
# the segmentation and PointBERT steps held across the legs (f32, ``ddp_steps``): part
# seg at the runner's B=16, sem seg at B=32 with seeded class weights (the synthetic
# S3DIS's own are all 1), ACT_PointBERT at B=128 with its queue K=16384 (``DDP_HELD``:
# also k's EMA change and the queue); "pbq" is PointBERT with the keys' gather left out
# of the enqueue (each rank enqueues its own keys only), which the queue's pointer and
# its unwritten columns, held exactly, must reject
DDP_SEG_B = {"ps": SEG_PART_B, "ss": SEG_SEM_B}
# the held steps (``ddp_steps``) of leg (a), leg (b) and the run without a group (leg
# (a) holds finetune and Stage II through their run_net)
DDP_PARTS = {"a": ("s1", "ps", "ss", "pb"),
             "b": ("ft", "ft16", "probe", "s2", "s1", "ps", "ss", "pb", "pbq")
             + tuple(DDP_FAULTS),
             "one": ("ft", "ft16", "probe", "s2", "s1", "ps", "ss", "pb"),
             "t": ("ft", "s2", "s1", "ps", "ss", "pb")}
# leg (t): leg (b)'s two ranks as a tensor-parallel grid of data 1 x DDP_TP, each rank
# the whole global batch and half of every split weight, held in f32 to the run
# without a group within DDP_RTOL (the kinds of DDP_HELD)
DDP_TP = 2
PREEMPT_AT = 2  # the finetune CLI gets its SIGTERM after this step, Stage II its hook
# the synthetic ModelNet40 of phase 38's finetune CLIs (legs (c) and (t)) and of the
# finetune run_net legs that leg (c) is held to: 4 steps an epoch at B=32 and 2
# validation batches (the dataset's 512 made 16 and 8, and these processes run beside
# phase 37's tracing); the part-seg CLI of leg (d) takes SEG_CLI_STEPS steps
DDP_FT_CLOUDS, DDP_FT_ENV = 128, "CHIP_SMOKE_FT_CLOUDS"
SEG_CLI_STEPS = 2
# leg (b)'s device and backend: gloo, both ranks on card 0 (NCCL takes one rank a card)
DDP_B = ("cuda:0", "gloo")
# the parent's directory for phase 38 (its CLIs run there beside phase 37), passed
# to phase 38's child (an environment variable holding a path)
DDP_TMP_ENV = "CHIP_SMOKE_DDP_DIR"
DDP_CLI_DEVICE = "cuda"
# runs ``act_tpu_torch.main`` with argv[2:] on DDP_FT_CLOUDS synthetic ModelNet
# clouds; after step argv[1] (0: never) it waits for the signal, so that the
# SIGTERM lands at that step boundary
CLI_WRAPPER = r"""
import os, sys, time
sys.path.insert(0, os.environ["ACT_ROOT"])
from act_tpu_torch.datasets import pointcloud_datasets
pointcloud_datasets.ModelNet.synthetic_len = int(os.environ["CHIP_SMOKE_FT_CLOUDS"])
from act_tpu_torch.engine import preemption, runner_finetune
stop_at, done, step = int(sys.argv[1]), [0], runner_finetune.train_step

def counted(*a, **k):
    out = step(*a, **k)
    done[0] += 1
    if done[0] == stop_at:
        print("[ddp] step %d dispatched, waiting for SIGTERM" % stop_at, flush=True)
        t0 = time.time()
        while not preemption.GUARD.requested and time.time() - t0 < 120:
            time.sleep(0.01)
    return out

runner_finetune.train_step = counted
from act_tpu_torch import main
main.main(sys.argv[2:])
"""


def ddp_inputs(tmp: str) -> None:
    """The global batches that legs (a) and (b) and the one-process run share:
    3 finetune batches of the train loader (32 ModelNet clouds of 8192
    points), 3 Stage-II batches of 128 and 2 Stage-I batches of 64 synthetic
    ShapeNet-55 clouds of 1024 points (each config's ``total_bs``), 3 part-seg
    batches of 16 and 3 sem-seg batches of 32 synthetic clouds of 2048 points
    with their labels (and one-hots; sem seg's class weights seeded), 3
    PointBERT batches of 128 clouds."""
    import numpy as np
    import torch
    from act_tpu_torch.datasets import synthetic_batch
    from act_tpu_torch.datasets.loader import DataLoader
    from act_tpu_torch.datasets.segmentation_datasets import PartNormalDataset, S3DISDataset
    from act_tpu_torch.engine import runner_finetune as rf
    from act_tpu_torch.engine.serve import load_config
    s2, s1 = load_config(PRETRAIN_CONFIG), load_config(AUTOENCODER_CONFIG)
    cfg = rf.finetune_config(CONFIG)
    (loader,) = rf.loaders(cfg, 0, ("train",))
    loader.set_epoch(0)
    ft = []
    for _, batch in zip(range(DDP_STEPS), loader):
        pts, labels = batch[2]
        ft.append((torch.as_tensor(pts), torch.as_tensor(labels)))
    ft_steps = max(len(loader), 1)  # the lr schedule's steps an epoch
    none = os.path.join(tmp, "no_data")  # absent: the datasets' synthetic clouds
    seg = {}
    for part, ds in (("ps", PartNormalDataset(none, SEG_NPOINT, split="trainval")),
                     ("ss", S3DISDataset("train", none, SEG_NPOINT))):
        batches = DataLoader(ds, DDP_SEG_B[part], shuffle=True, drop_last=True, prefetch=0)
        seg[part] = []
        for _, b in zip(range(DDP_STEPS), batches):
            oh = (torch.from_numpy(np.eye(16, dtype=np.float32)[np.asarray(b[1])])
                  if part == "ps" else None)
            seg[part].append((torch.from_numpy(np.asarray(b[0])[..., :3]),
                              torch.as_tensor(b[-1]), oh))
    torch.save({"ft": ft, "ft_steps": ft_steps, **seg,
                "ss_weight": torch.from_numpy(
                    np.random.default_rng(3).uniform(0.5, 3.0, 13).astype(np.float32)),
                "pb": [torch.from_numpy(synthetic_batch(20 + i, int(s2.total_bs),
                                                        int(s2.dataset.train.others.npoints)))
                       for i in range(DDP_STEPS)],
                "s2": [torch.from_numpy(synthetic_batch(
                    i, int(s2.total_bs), int(s2.dataset.train.others.npoints)))
                    for i in range(DDP_STEPS)],
                "s1": [torch.from_numpy(synthetic_batch(
                    50 + i, int(s1.total_bs), int(s1.dataset.train.others.npoints)))
                    for i in range(DDP_S1_STEPS)]}, os.path.join(tmp, "batches.pt"))


def ddp_took(part, t0) -> None:
    """One ``[ddp]`` line: this rank's seconds on ``part`` of phase 38 since ``t0``."""
    from act_tpu_torch import parallel
    print(f"[ddp] rank {parallel.process_index()} of {parallel.process_count()}: {part} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def ddp_state(model, optimizer, start, full: bool):
    """(the trained tensors' change from ``start``, the BN running statistics,
    Adam's first moments; for ACT_PointBERT also the EMA-moved k encoder's
    change and the MoCo queue) on the host, or per tensor the float64 sum
    (``ddp_sum``) when not ``full``; a model sharded over a TP grid in the
    full layout (every rank gathers)."""
    from act_tpu_torch.parallel import tp
    params = {n: p for n, p in model.named_parameters() if n in start}
    trained = {n: p for n, p in params.items() if p.requires_grad}
    stats = {n: b for n, b in model.named_buffers() if "running" in n}
    kinds = {"dw": {n: p.detach() - start[n] for n, p in trained.items()}, "bn": stats,
             "m": {n: optimizer.state[p]["exp_avg"] for n, p in trained.items()}}
    if hasattr(model, "queue"):
        kinds["k"] = {n: p.detach() - start[n] for n, p in params.items() if not p.requires_grad}
        kinds["q"] = {"queue": model.queue}
    kinds = {tag: tp.full_tensors(model, tensors) for tag, tensors in kinds.items()}
    return {tag: {n: (t.detach().float().cpu().clone() if full else ddp_sum(t))
                  for n, t in tensors.items()} for tag, tensors in kinds.items()}


def ddp_start(model):
    """A copy of the model's trained tensors (and ACT_PointBERT's k encoder),
    after the start broadcast."""
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad or n.startswith("transformer_k.")}


def ddp_sum(t) -> float:
    """A tensor's float64 sum in numpy's pairwise order (the same in every
    process, whatever its threads)."""
    return float(t.detach().double().cpu().numpy().sum())


def ddp_part_end(dev, tmp, part, model, optimizer, rec, steps) -> None:
    """What each held part of phase 38 adds to its record ``rec``: the peak
    device memory of the part and every parameter's size; under a TP grid
    (leg (t)) the MB that *f* and *g* all-reduced a step, a digest of every
    tensor the rank holds (parameters, buffers, Adam's first moments), the
    full-layout checkpoint ``tp-<part>.pth`` written (``save_checkpoint``)
    and each rank's shards read back from it; without a group, that
    checkpoint, where leg (t) wrote it, loaded with ``strict=True``."""
    import hashlib

    import torch
    from act_tpu_torch.engine import checkpoint as ckpt_lib
    from act_tpu_torch.parallel import mesh, tp
    if dev.type == "cuda":
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    rec["numels"] = {n: p.numel() for n, p in model.named_parameters()}
    path = os.path.join(tmp, f"tp-{part}.pth")
    if tp.is_sharded(model):
        rec["tp_mb"] = tp.TRAFFIC["bytes"] / 1e6 / steps
        rec["tp_calls"] = tp.TRAFFIC["calls"] / steps

        def digest(t):
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
            return hashlib.sha1(raw.tobytes()).hexdigest()
        params = dict(model.named_parameters())
        held = {**{("p", n): (p, p) for n, p in params.items()},
                **{("b", n): (b, None) for n, b in model.named_buffers()},
                **{("m", n): (optimizer.state[p]["exp_avg"], p) for n, p in params.items()
                   if p in optimizer.state}}
        rec["digests"] = {k: (digest(t), t.numel(), getattr(p, "tp_split", None))
                          for k, (t, p) in held.items()}
        ckpt_lib.save_checkpoint(model, optimizer, steps, 0, None, None, f"tp-{part}", tmp)
        saved = torch.load(path, map_location="cpu", weights_only=True)["base_model"]
        T, m = mesh.model_count(), mesh.model_index()
        rec["ckpt_shards"] = all(
            torch.equal(tp._shard(saved[n], p.tp_split, T, m) if hasattr(p, "tp_split")
                        else saved[n], p.detach().cpu()) for n, p in params.items())
        rec["ckpt_mib"] = os.path.getsize(path) / 2 ** 20
    elif not mesh.is_distributed() and os.path.exists(path):
        saved = torch.load(path, map_location=dev, weights_only=True)["base_model"]
        model.load_state_dict(saved, strict=True)
        rec["tp_ckpt_strict"] = True
        os.remove(path)



def ddp_warm(dev) -> None:
    """One eval-mode forward and backward of phase 38's finetune model on
    random clouds, nothing kept and no collective: a process's first CUDA
    work (cuBLAS's set-up, the kernels' lazy loading; ~9 s of the first held
    part, NVIDIA H100 80GB HBM3, 700 W) done beside phase 37's tracing, before the
    process says it is ready, so that it leaves the held steps' path."""
    import torch
    from act_tpu_torch.engine import runner_finetune as rf
    from act_tpu_torch.engine.serve import load_model
    cfg = ddp_f32(cut_depth(rf.finetune_config(CONFIG)))
    model = load_model(cfg, seed=1, device=dev)
    x = torch.randn(4, int(cfg.npoints), 3, generator=torch.Generator().manual_seed(1)).to(dev)
    model(x).float().sum().backward()
    torch.cuda.synchronize(dev)
    del model
    torch.cuda.empty_cache()


def ddp_f32(cfg):
    """``cfg`` computing in f32 (the held steps of legs (a) and (b))."""
    m = cfg.model
    for node in (m, m.get("transformer_config"), m.get("dvae_config")):
        if node is not None and "dtype" in node:
            node.dtype = "f32"
    return cfg


def ddp_fault(kind):
    """The gradient all-reduce gone wrong: ``missing`` leaves each rank its
    own gradients, ``unscaled`` sums them without dividing by R."""
    from act_tpu_torch import parallel
    if kind == "missing":
        return lambda tensors: None

    def unscaled(tensors):
        parallel.all_reduce_mean(tensors)
        for t in tensors:
            if t is not None:
                t.mul_(parallel.process_count())
    return unscaled


def ddp_steps(dev, tmp, parts, replay=None):
    """The held steps of ``parts`` on this rank's rows of the global batches
    (its share under a group, all of them without): "ft" finetune
    ``run_finetune_steps`` in f32 (``ddp_f32``), "ft16" the same in the
    shipped bf16, each of ``DDP_FAULTS`` the f32 finetune steps with that
    fault in the gradient all-reduce (``ddp_fault``), "probe" Stage II's probe
    features gathered over the ranks, "s2" Stage-II ``pretrain_step`` in f32,
    "s1" Stage-I ``autoencoder_step`` in f32, then the segmentation and
    PointBERT steps (``ddp_seg_bert_steps``). ``replay``: the tokenizer ids of
    leg (b)'s ranks, concatenated, in place of the Gumbel kernel's. Returns
    the losses, states (rank 0: whole), launches, ids drawn, features, and
    each step's host ms with the gradient all-reduce's alone."""
    import torch
    from act_tpu_torch import ops, parallel
    from act_tpu_torch.engine import builder, train_state
    from act_tpu_torch.engine import runner_autoencoder as ra
    from act_tpu_torch.engine import runner_finetune as rf
    from act_tpu_torch.engine import runner_pretrain as rp
    from act_tpu_torch.engine.serve import load_config
    from act_tpu_torch.engine.train_state import (autoencoder_step, pretrain_step, step_rngs,
                                                  steps_per_epoch)
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.parallel import tp
    R, r = parallel.data_count(), parallel.process_index()
    d = parallel.data_index()
    inputs = torch.load(os.path.join(tmp, "batches.pt"), weights_only=True)

    def rows(t):
        b = t.shape[0] // R
        return t[d * b:(d + 1) * b].to(dev)

    def begin():
        _backend.reset_launches()
        tp.reset_traffic()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def reduce_ms(params):
        grads = [p.grad for p in params if p.grad is not None]
        return (statistics.median(request_ms(lambda: parallel.all_reduce_mean(grads), 3))
                if parallel.is_distributed() else None)

    out = {"rank": r, "ranks": parallel.process_count(), "backend": torch.distributed.get_backend()
           if parallel.is_distributed() else None}
    # finetune: f32, bf16, the faults
    for part in ("ft", "ft16") + tuple(DDP_FAULTS):
        if part not in parts:
            continue
        t0 = time.perf_counter()
        cfg = cut_depth(rf.finetune_config(CONFIG))
        cfg = cfg if part == "ft16" else ddp_f32(cfg)
        st = rf.build_state(cfg, inputs["ft_steps"], 0, dev)
        parallel.broadcast_module(st.model)
        start = ddp_start(st.model)
        reduce = ddp_fault(part) if part in DDP_FAULTS else train_state.all_reduce_mean
        begin()
        with patched(train_state, all_reduce_mean=reduce):
            run = rf.run_finetune_steps(cfg, DDP_STEPS, device=dev, state=st,
                                        batches=[(rows(p), rows(y)) for p, y in inputs["ft"]])
        torch.cuda.synchronize()
        out[part] = dict(losses=run.losses, launches=dict(_backend.LAUNCHES),
                         state=ddp_state(st.model, st.optimizer, start, r == 0),
                         step_ms=run.step_ms, reduce_ms=reduce_ms(st.model.parameters()),
                         grad_mb=sum(q.numel() * 4 for q in st.model.parameters()
                                     if q.requires_grad) / 1e6)
        ddp_part_end(dev, tmp, part, st.model, st.optimizer, out[part], DDP_STEPS)
        del run, st, start
        ddp_took(part, t0)
    # Stage II: the probe's features, then the steps
    if "probe" in parts or "s2" in parts:
        t0 = time.perf_counter()
        cfg = ddp_f32(cut_depth(load_config(PRETRAIN_CONFIG)))
        model = rp.freeze_tokenizer(rp.build_pretrain_model(cfg.model, 0), cfg).to(dev)
        parallel.broadcast_module(tp.shard_module(model))
        if "probe" in parts:
            node = cfg.dataset.val
            node.others.bs = DDP_PROBE_BS
            probe_loader = builder.dataset_builder(node, 0)[1]
            out["probe"] = dict(zip(("feats", "labels"), rp.probe_features(
                model, probe_loader, int(node.others.npoints))))
        if "s2" in parts:
            optimizer, schedule = builder.build_optimizer(cfg, model, steps_per_epoch(cfg))
            clip, ids, calls, start = cfg.get("grad_norm_clip", None), [], [0], ddp_start(model)
            kernel = ops.gumbel_argmax

            def gumbel(logits, seed):
                if replay is None:
                    got = kernel(logits, seed)
                    ids.append(got.cpu())
                    return got
                calls[0] += 1
                return replay[calls[0] - 1].to(logits.device)
            begin()
            with patched(ops, gumbel_argmax=gumbel):
                losses, ms, red = ddp_timed_steps(
                    lambda i: pretrain_step(model, optimizer, schedule, rows(inputs["s2"][i]), i,
                                            step_rngs(0, i, dev), grad_norm_clip=clip),
                    model.parameters())
            out["s2"] = dict(losses=losses, launches=dict(_backend.LAUNCHES), step_ms=ms,
                             reduce_ms=red, state=ddp_state(model, optimizer, start, r == 0),
                             ids=ids, grad_mb=sum(q.numel() * 4 for q in model.parameters()
                                                  if q.requires_grad) / 1e6)
            ddp_part_end(dev, tmp, "s2", model, optimizer, out["s2"], DDP_STEPS)
            del optimizer, start
        del model
        torch.cuda.empty_cache()
        ddp_took("probe and s2", t0)
    if "s1" in parts:
        t0 = time.perf_counter()
        cfg = ddp_f32(cut_depth(load_config(AUTOENCODER_CONFIG)))
        model = ra.prepare_model(cfg, 0, dev)
        parallel.broadcast_module(model)
        optimizer, schedule = builder.build_optimizer(cfg, model, steps_per_epoch(cfg))
        start = ddp_start(model)
        begin()

        def s1_step(i):
            n = DDP_S1_ITR + i
            return autoencoder_step(model, optimizer, schedule, rows(inputs["s1"][i]), i,
                                    step_rngs(0, i, dev), ra.get_temp(cfg, n),
                                    ra.get_kld_weight(cfg, n), cfg.get("grad_norm_clip"))[0]
        losses, ms, red = ddp_timed_steps(s1_step, model.parameters(), DDP_S1_STEPS)
        out["s1"] = dict(losses=losses, launches=dict(_backend.LAUNCHES), step_ms=ms,
                         reduce_ms=red, state=ddp_state(model, optimizer, start, r == 0),
                         grad_mb=sum(q.numel() * 4 for q in model.parameters()
                                     if q.requires_grad) / 1e6)
        ddp_part_end(dev, tmp, "s1", model, optimizer, out["s1"], DDP_S1_STEPS)
        del model, optimizer, start
        torch.cuda.empty_cache()
        ddp_took("s1", t0)
    out.update(ddp_seg_bert_steps(dev, tmp, inputs, parts, rows, begin))
    return out


def ddp_timed_steps(step, params, steps=DDP_STEPS):
    """Run ``step(i)`` for the held steps, each ended by a device synchronize;
    returns (their losses, host ms of each, host ms of the gradient all-reduce
    alone on the last step's gradients, median of 3, under a group)."""
    import torch
    from act_tpu_torch import parallel
    losses, ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(i)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    grads = [p.grad for p in params if p.grad is not None]
    reduce_ms = (statistics.median(request_ms(lambda: parallel.all_reduce_mean(grads), 3))
                 if parallel.is_distributed() else None)
    return losses, ms, reduce_ms


def ddp_seg_bert_steps(dev, tmp, inputs, parts, rows, begin):
    """The held f32 steps of part seg ("ps", the runner's augmentation drawn
    for the global batch), sem seg with class weights ("ss") and
    ACT_PointBERT ("pb"; "pbq" with each rank enqueueing its own keys only)
    on this rank's rows of the global batches: losses, state (rank 0 whole),
    launches, the step's host ms and the gradient all-reduce's alone, the
    all-reduced MB, PointBERT's queue pointer (``ddp_part_end``'s record too).
    ``begin`` resets the launch and traffic counts and the peak memory."""
    import numpy as np
    import torch
    from act_tpu_torch import parallel
    from act_tpu_torch.engine import builder
    from act_tpu_torch.engine import runner_pretrain as rp
    from act_tpu_torch.engine import runner_segmentation as rs
    from act_tpu_torch.engine.train_state import (pretrain_step, seg_step, step_rngs,
                                                  steps_per_epoch)
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.parallel import tp
    R, r = parallel.data_count(), parallel.data_index()
    out = {}
    for part in ("ps", "ss"):
        if part not in parts:
            continue
        t0 = time.perf_counter()
        st = rs.build_seg_state("partseg" if part == "ps" else "semseg", 32, dtype="f32",
                                device=dev, widths=CUT_SEG_WIDTHS)
        parallel.broadcast_module(st.model)
        start = ddp_start(st.model)
        weight = inputs["ss_weight"].to(dev) if part == "ss" else None
        batches = [(torch.from_numpy(rs._np_augment(np.random.default_rng(i),
                                                    rows(p).cpu().numpy())).to(dev),
                    rows(y), None if oh is None else rows(oh))
                   for i, (p, y, oh) in enumerate(inputs[part])]
        begin()
        losses, ms, reduce_ms = ddp_timed_steps(
            lambda i: seg_step(st.model, st.optimizer, st.schedule, batches[i][0],
                               batches[i][1], i, step_rngs(0, i, dev), batches[i][2], weight),
            st.model.parameters())
        out[part] = dict(losses=losses, launches=dict(_backend.LAUNCHES), step_ms=ms,
                         reduce_ms=reduce_ms, state=ddp_state(st.model, st.optimizer, start,
                                                              r == 0),
                         grad_mb=sum(q.numel() * 4 for q in st.model.parameters()
                                     if q.requires_grad) / 1e6)
        ddp_part_end(dev, tmp, part, st.model, st.optimizer, out[part], DDP_STEPS)
        del st, start
        torch.cuda.empty_cache()
        ddp_took(part, t0)
    if "pb" not in parts:
        return out
    cfg = ddp_f32(cut_depth(pointbert_config()))
    model = rp.freeze_tokenizer(rp.build_pretrain_model(cfg.model, 0), cfg).to(dev)
    parallel.broadcast_module(tp.shard_module(model))
    start, clip, m = ddp_start(model), cfg.get("grad_norm_clip", None), rp.ema_momentum(cfg)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    enqueue, pts = model.enqueue, [rows(p) for p in inputs["pb"]]
    for part in ("pb", "pbq"):
        if part not in parts:
            continue
        t0 = time.perf_counter()
        model.load_state_dict(initial)
        optimizer, schedule = builder.build_optimizer(cfg, model, steps_per_epoch(cfg))
        if part == "pbq":
            model.enqueue = lambda keys: enqueue(keys.narrow(0, r * (keys.shape[0] // R),
                                                             keys.shape[0] // R))
        begin()
        losses, ms, reduce_ms = ddp_timed_steps(
            lambda i: pretrain_step(model, optimizer, schedule, pts[i], i, step_rngs(0, i, dev),
                                    grad_norm_clip=clip, ema_momentum=m),
            model.parameters())
        out[part] = dict(losses=losses, launches=dict(_backend.LAUNCHES), step_ms=ms,
                         reduce_ms=reduce_ms, state=ddp_state(model, optimizer, start, r == 0),
                         ptr=int(model.queue_ptr), grad_mb=sum(
                             q.numel() * 4 for q in model.parameters() if q.requires_grad) / 1e6)
        if part == "pb":
            ddp_part_end(dev, tmp, part, model, optimizer, out[part], DDP_STEPS)
        del optimizer
        ddp_took(part, t0)
    del model, start, initial
    torch.cuda.empty_cache()
    return out


def ddp_run_nets(dev, tmp, tag):
    """Leg (a)'s and the one-process run's user path: finetune ``run_net`` and
    Stage-II ``run_net`` (no probe, a random tokenizer) for one epoch each,
    their checkpoints under ``tmp/{ft,s2}-{tag}``; returns their epoch losses
    and steps."""
    from act_tpu_torch.engine import runner_finetune as rf
    from act_tpu_torch.engine import runner_pretrain as rp
    ft = rf.run_net(cut_depth(rf.finetune_config(CONFIG)), device=dev, epochs=1,
                    experiment_path=os.path.join(tmp, f"ft-{tag}"))
    s2 = rp.run_net(ddp_pretrain_config(), device=dev, epochs=1, allow_random_tokenizer=True,
                    experiment_path=os.path.join(tmp, f"s2-{tag}"))
    return dict(ft_loss=ft.epoch_loss, ft_steps=ft.steps, s2_loss=s2.epoch_loss,
                s2_steps=s2.step)


def ddp_pretrain_config():
    """``pretrain_act_distill.yaml`` without the probe's datasets (leg (b)
    checks the probe's gather) and without a Stage-I checkpoint, cut
    (``cut_depth``)."""
    from act_tpu_torch.engine.serve import load_config
    cfg = cut_depth(load_config(PRETRAIN_CONFIG))
    del cfg.dataset["val"], cfg.dataset["extra_train"]
    cfg.model.dvae_config.ckpt = None
    return cfg


def ddp_rank(tmp: str) -> None:
    """A rank of leg (b) (gloo, two ranks, both on card 0), launched with
    torchrun's variables: it joins the group, loads the kernels, waits for
    ``go-b`` (phase 37 has ended and the batches are written), then takes
    the steps; writes ``leg-b-<rank>.pt``. Then the ranks form leg (t)'s
    grid (``initialize_model_parallel(DDP_TP)``) and take the held steps of
    ``DDP_PARTS['t']`` on the whole global batch; writes ``leg-t-<rank>.pt``.
    A rank that raises exits non-zero."""
    import torch
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from act_tpu_torch import parallel
    from act_tpu_torch.ops import _backend
    parallel.initialize_distributed(DDP_B[0], backend=DDP_B[1])
    dev = parallel.local_device(DDP_B[0])
    if not parallel.is_distributed():
        fail("leg (b): no process group")
    _backend.build_kernels()
    ddp_warm(dev)
    open(os.path.join(tmp, f"ready-b-{parallel.process_index()}"), "w").close()
    wait_for(os.path.join(tmp, "go-b"), "leg (b)'s start")
    r = parallel.process_index()
    out = ddp_steps(dev, tmp, DDP_PARTS["b"])
    torch.save(out["s2"]["ids"], os.path.join(tmp, f"ids-b-{r}.pt"))
    torch.save(out, os.path.join(tmp, f"leg-b-{r}.pt"))
    del out
    # leg (t): the same ranks as data 1 x model DDP_TP, leg (b)'s tokenizer ids replayed
    # as the run without a group replays them
    parallel.barrier()
    ids = [torch.load(os.path.join(tmp, f"ids-b-{q}.pt"), weights_only=True) for q in (0, 1)]
    replay = [torch.cat(pair) for pair in zip(*ids)]
    parallel.initialize_model_parallel(DDP_TP)
    t0 = time.perf_counter()
    out = ddp_steps(dev, tmp, DDP_PARTS["t"], replay)
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(tmp, f"leg-t-{r}.pt"))
    parallel.destroy_distributed()


def torchrun_env(ranks: int) -> dict:
    """torchrun's variables for ``ranks`` ranks on this host, less ``RANK``
    and ``LOCAL_RANK``, at a free port."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": str(ranks)}


def ddp_start_b(tmp: str) -> list:
    """Start leg (b)'s two ranks, each a process started as torchrun would
    start it (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); they join their group and wait for ``tmp/go-b``."""
    env = {**os.environ, **torchrun_env(2)}
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-rank", tmp],
                             cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": "0"})
            for r in range(2)]


def ddp_finish_b(tmp: str, procs: list) -> list:
    """Wait for leg (b)'s ranks; fails if one fails, returns their results."""
    import torch
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        stop_processes(procs)
    if any(rcs):
        fail(f"leg (b): rank exit codes {rcs}")
    return [torch.load(os.path.join(tmp, f"leg-b-{r}.pt"), weights_only=False) for r in (0, 1)]


@contextmanager
def one_nccl_rank():
    """Leg (a)'s group: this process as the one rank of an NCCL group made
    from torchrun's variables (``initialize_distributed``), left on exit."""
    from act_tpu_torch import parallel
    env = {**torchrun_env(1), "RANK": "0", "LOCAL_RANK": "0"}
    os.environ.update(env)
    try:
        parallel.initialize_distributed("cuda")
        if not parallel.is_distributed():
            fail("leg (a): no process group")
        yield
    finally:
        parallel.destroy_distributed()
        for k in env:
            del os.environ[k]


def ddp_compare(tag, got, want):
    """A state (``ddp_state``) against another of the same tensors: for each
    kind (the weights' change, the BN statistics, the Adam moments) the norm
    of the difference over all its tensors against the norm of ``want``'s (a
    near tie of a kNN or max choice that rounding flips moves a few gradients
    by their own size; a missing or unscaled reduction moves all of them), and
    the tensor of the largest difference against its own largest value.
    Returns {kind: (the measure, that tensor)}."""
    worst = {}
    for kind in want:
        if sorted(got[kind]) != sorted(want[kind]):
            fail(f"ddp {tag}: the tensors of {kind} differ")
        d2 = r2 = w = 0.0
        at = None
        for n, t in got[kind].items():
            ref = want[kind][n].double()
            diff = t.double() - ref
            d2, r2 = d2 + float((diff ** 2).sum()), r2 + float((ref ** 2).sum())
            if t.numel():
                rel = diff.abs().max().item() / max(ref.abs().max().item(), 1e-30)
                if rel > w:
                    w, at = rel, n
        worst[kind] = ((d2 / max(r2, 1e-300)) ** 0.5, at)
    return worst


def ddp_measures(worst) -> str:
    return ", ".join(f"{k} {v[0]:.3e}" for k, v in worst.items())


def ddp_tp_check(t, one):
    """Leg (t) (``DDP_PARTS['t']`` over data 1 x model ``DDP_TP``) against
    the run without a group: the losses (the same on both ranks) and each
    kind of ``DDP_HELD`` within ``DDP_RTOL``; every replicated tensor
    (parameters, buffers, Adam's first moments) bit-equal on the ranks
    (digests), each split one 1 / ``DDP_TP`` of the no-group model's; the
    kernels the no-group steps launched; the ranks' shards read back from
    their full-layout checkpoint, which the no-group model loaded with
    ``strict=True``. Prints each rank-step's host ms, the MB *f* and *g*
    all-reduced a step and each rank's peak memory beside the no-group
    peak. Returns the problems found."""
    problems = []
    for model in DDP_PARTS["t"]:
        r0, r1, want = t[0][model], t[1][model], one[model]
        loss_err = max(abs(g - w) / abs(w) for g, w in zip(r0["losses"], want["losses"]))
        worst = ddp_compare(f"t {model}", r0["state"], want["state"])
        bad = [k for k in DDP_HELD[model] if worst[k][0] > DDP_RTOL[model]]
        rep_diff = [k for k, (h, _, split) in r0["digests"].items()
                    if split is None and r1["digests"][k][0] != h]
        split = {k[1]: n for k, (_, n, kind) in r0["digests"].items() if kind and k[0] == "p"}
        wrong = [k for k, n in r0["numels"].items()
                 if n * (DDP_TP if k in split else 1) != want["numels"][k]]
        launches = r0["launches"] == r1["launches"] == want["launches"]
        ckpt = r0["ckpt_shards"] and r1["ckpt_shards"] and want.get("tp_ckpt_strict", False)
        print(f"[ddp] (t) {model}: losses {r0['losses']} (rank 1 the same: "
              f"{r0['losses'] == r1['losses']}; no group {want['losses']}, max relative "
              f"{loss_err:.3e}); relative norm of the difference: {ddp_measures(worst)} "
              f"(tolerance {DDP_RTOL[model]} on {', '.join(DDP_HELD[model])}); "
              f"{sum(kind is None for _, _, kind in r0['digests'].values())} replicated "
              f"tensors, {len(rep_diff)} "
              f"differ between the ranks; {len(split)} split parameters at 1/{DDP_TP} of the "
              f"no-group model's ({len(wrong)} not); launches a rank "
              f"{ {k: v for k, v in r0['launches'].items() if v} } equal to the no-group "
              f"run's: {launches}; checkpoint {r0['ckpt_mib']:.1f} MiB, the shards read back "
              f"and a model without a group loads it strictly: {ckpt}", flush=True)
        if loss_err > DDP_RTOL[model] or bad or r0["losses"] != r1["losses"]:
            problems.append(f"(t) {model}: beyond the tolerance: losses {loss_err}, {bad}")
        if rep_diff or wrong or not split or not launches or not ckpt:
            problems.append(f"(t) {model}: replicated {rep_diff[:4]}, sizes {wrong[:4]}, "
                            f"launches {launches}, checkpoint {ckpt}")
    for model, tag, bs in (("ft", "finetune", 32), ("s2", "Stage-II", 128), ("s1", "Stage-I", 64),
                           ("ps", "part-seg", SEG_PART_B), ("ss", "sem-seg", SEG_SEM_B),
                           ("pb", "PointBERT", 128)):
        for r in (0, 1):
            res = t[r][model]
            med = statistics.median(res["step_ms"][1:])
            print(f"[time] ddp {tag} f32 step, TP data 1 x model {DDP_TP}, B={bs}, gloo rank "
                  f"{r}: host ms {[round(x, 3) for x in res['step_ms']]}, median after the "
                  f"first {med:.3f}; f and g all-reduce {res['tp_mb']:.1f} MB a step in "
                  f"{res['tp_calls']:.0f} calls; peak {res.get('peak_gib', math.nan):.3f} GiB "
                  f"(no group {one[model].get('peak_gib', math.nan):.3f} GiB)", flush=True)
    print(f"[ddp] leg (t): {t[0]['seconds']:.1f} s on rank 0", flush=True)
    return problems


def ddp(dev, device_ms, kernel_events, measure):
    """Phase 38, data parallelism and preemption at full width, in the
    directory of ``DDP_TMP_ENV`` (the parent's, where the CLIs of legs (c)
    and (d) ran beside phase 37's tracing): (b) two ranks sharing the card
    over gloo (finetune at 16 + 16 in f32, in bf16 and with the fault of
    ``DDP_FAULTS``, Stage II at 64 + 64, Stage I at 32 + 32 clouds, the
    probe's features gathered; part seg at 8 + 8, sem seg at 16 + 16 with
    class weights, ACT_PointBERT at 64 + 64, also with the keys' gather left
    out of its enqueue); then in this process the same steps without a
    group, then (a) this process as one rank over NCCL: the f32 steps of
    Stage I, part seg, sem seg and PointBERT, held bit for bit to the run
    without a group; (b) held within ``DDP_RTOL`` to the run without a group
    (PointBERT's queue pointer and unwritten columns exactly); (t) leg (b)'s
    ranks as data 1 x model 2 (``ddp_tp_check``); each held step timed, with
    the gradient all-reduce alone, each leg alone on the card.
    The ``run_net`` legs ran beside phase 37 (``ddp_runs``). Returns (no
    timing rows, errors, each leg's launches). Started beside phase 37, it
    starts leg (b)'s ranks and waits for ``go`` (phase 37 has ended)."""
    import numpy as np
    import torch
    tmp = os.environ[DDP_TMP_ENV]
    procs = ddp_start_b(tmp)
    ddp_warm(dev)
    open(os.path.join(tmp, "ready-one"), "w").close()
    try:
        wait_for(os.path.join(tmp, "go"), "the end of phase 37", timeout=1200)
    except SystemExit:
        stop_processes(procs)
        raise
    t_phase = time.perf_counter()
    ddp_inputs(tmp)
    launches = {}
    steps = {**{m: DDP_STEPS for m in DDP_PARTS["b"] if m in DDP_PER_STEP}, "s1": DDP_S1_STEPS}

    # (b) two ranks on the one card, over gloo, alone
    t0 = time.perf_counter()
    open(os.path.join(tmp, "go-b"), "w").close()
    b = ddp_finish_b(tmp, procs)
    tp_legs = [torch.load(os.path.join(tmp, f"leg-t-{r}.pt"), weights_only=False) for r in (0, 1)]
    print(f"[ddp] legs (b) and (t): 2 ranks over {b[0]['backend']} on one card, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for r, res in enumerate(b):
        for model, n in steps.items():
            check_launches(f"ddp (b) rank {r} {model}", res[model]["launches"],
                           DDP_PER_STEP[model], n)
            launches[f"(b) rank {r} {model}"] = res[model]["launches"]
        print(f"[ddp] (b) rank {r}: launches a step: " + ", ".join(
            f"{model} { {k: v // n for k, v in res[model]['launches'].items() if v} }"
            for model, n in steps.items() if model in ("ft", "s2", "s1", "ps", "ss", "pb")),
            flush=True)
    for model in steps:
        if model == "pbq":  # each rank's queue holds its own keys: they differ by design
            continue
        sums = {k: {n: ddp_sum(t) for n, t in v.items()} for k, v in b[0][model]["state"].items()}
        if sums != b[1][model]["state"]:
            bad = [(k, n) for k, v in sums.items() for n, x in v.items()
                   if x != b[1][model]["state"][k][n]]
            fail(f"ddp (b) {model}: the two ranks' states differ at {bad[:8]}")
    print("[ddp] (b) the two ranks' weights, BN statistics and Adam moments (PointBERT: k and "
          "the queue) agree (float64 sums of every tensor equal; f32 and bf16)", flush=True)
    # the run without a group, then (a) one rank over NCCL, each with (b)'s tokenizer ids
    # replayed and alone on the card
    replay = [torch.cat(pair) for pair in zip(b[0]["s2"]["ids"], b[1]["s2"]["ids"])]
    t0 = time.perf_counter()
    one = ddp_steps(dev, tmp, DDP_PARTS["one"], replay)
    print(f"[ddp] one process, no group: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with one_nccl_rank():
        a = ddp_steps(dev, tmp, DDP_PARTS["a"], replay)
    print(f"[ddp] leg (a): 1 rank over {a['backend']}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    for model in DDP_PARTS["a"]:
        launches[f"(a) {model}"] = a[model]["launches"]
    print(f"[ddp] legs (b), (a) and the run without a group: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    errs, problems = {}, []
    for model in DDP_PARTS["a"]:
        same = a[model]["losses"] == one[model]["losses"] and a[model].get("ptr") == one[
            model].get("ptr") and all(torch.equal(t, one[model]["state"][k][n])
                                      for k, v in a[model]["state"].items() for n, t in v.items())
        print(f"[ddp] (a) {model}: losses {a[model]['losses']} (no group: "
              f"{one[model]['losses']}), every held tensor ({', '.join(a[model]['state'])}) "
              f"bit-equal to the run without a group: {same}", flush=True)
        if not same:
            problems.append(f"(a) {model}: the one-rank NCCL run differs from the run without "
                            f"a group")
    for model in ("ft", "s2", "s1", "ps", "ss", "pb"):
        got_loss = [sum(x) / 2 for x in zip(b[0][model]["losses"], b[1][model]["losses"])]
        loss_err = max(abs(g - w) / abs(w) for g, w in zip(got_loss, one[model]["losses"]))
        worst = ddp_compare(model, b[0][model]["state"], one[model]["state"])
        bad = [k for k in DDP_HELD[model] if worst[k][0] > DDP_RTOL[model]]
        print(f"[ddp] (b) {model}: mean losses of the ranks {got_loss} against one rank's "
              f"{one[model]['losses']} (max relative {loss_err:.3e}); relative norm of the "
              f"difference: {ddp_measures(worst)} (tolerance {DDP_RTOL[model]} on "
              f"{', '.join(DDP_HELD[model])}; the largest tensor-wise: "
              f"{[v[1] for v in worst.values()]})", flush=True)
        if loss_err > DDP_RTOL[model] or bad:
            problems.append(f"(b) {model}: 2 ranks against 1 rank beyond the tolerance: losses "
                            f"{loss_err}, {bad}")
        errs[f"ddp {model}"] = worst["m"][0]
    # PointBERT's queue: the pointer and the columns not yet written exact, with and
    # without the keys' gather in the enqueue (the fault must be rejected)
    for model, must_pass in (("pb", True), ("pbq", False)):
        ptr, want_ptr = b[0][model]["ptr"], one["pb"]["ptr"]
        q, want_q = b[0][model]["state"]["q"]["queue"], one["pb"]["state"]["q"]["queue"]
        unwritten = torch.equal(q[:, want_ptr:], want_q[:, want_ptr:])
        ok = ptr == b[1][model]["ptr"] == want_ptr and unwritten
        worst = ddp_compare(model, b[0][model]["state"], one["pb"]["state"])
        print(f"[ddp] (b) {model}: queue pointer {ptr} on rank 0, {b[1][model]['ptr']} on rank "
              f"1 (one rank: {want_ptr}), the unwritten columns bit-equal {unwritten}, relative "
              f"norm of the difference: {ddp_measures(worst)}; "
              f"{'held' if ok else 'rejected'}{'' if must_pass else ' (the fault: must be rejected)'}",
              flush=True)
        if ok != must_pass:
            problems.append(f"(b) {model}: the queue check {'rejects' if must_pass else 'passes'}")
    # the faults: the same check must reject each that changes the step
    for fault, must in DDP_FAULTS.items():
        worst = ddp_compare(fault, b[0][fault]["state"], one["ft"]["state"])
        caught = [k for k in DDP_HELD["ft"] if worst[k][0] > DDP_RTOL["ft"]]
        print(f"[ddp] (b) ft with the gradient reduction {fault}: relative norm of the "
              f"difference from one rank: {ddp_measures(worst)}; beyond the tolerance "
              f"{DDP_RTOL['ft']}: {caught}{'' if must else ' (read only)'}", flush=True)
        if must and not caught:
            problems.append(f"(b) the check does not catch a {fault} gradient reduction")
    # the shipped bf16: 2 ranks against one rank's f32, beside one rank's bf16 against its f32
    own = ddp_compare("ft16", one["ft16"]["state"], one["ft"]["state"])
    got = ddp_compare("ft16", b[0]["ft16"]["state"], one["ft"]["state"])
    pair = ddp_compare("ft16", b[0]["ft16"]["state"], one["ft16"]["state"])
    print(f"[ddp] (b) ft in bf16: one rank's bf16 against its f32: {ddp_measures(own)}; 2 ranks' "
          f"bf16 against one rank's f32: {ddp_measures(got)}; 2 ranks' bf16 against one rank's "
          f"bf16: {ddp_measures(pair)}; losses 2 ranks "
          f"{[sum(x) / 2 for x in zip(b[0]['ft16']['losses'], b[1]['ft16']['losses'])]}, one "
          f"rank {one['ft16']['losses']}, one rank f32 {one['ft']['losses']} (tolerance: "
          f"{DDP_BF16_FACTOR} x one rank's bf16 against its f32)", flush=True)
    bad = [k for k in own if got[k][0] > DDP_BF16_FACTOR * own[k][0]]
    if bad:
        problems.append(f"(b) ft in bf16: 2 ranks farther from f32 than {DDP_BF16_FACTOR} x one "
                        f"rank's bf16: {bad}")
    errs["ddp ft bf16"] = got["m"][0]
    problems += ddp_tp_check(tp_legs, one)
    if problems:
        fail("ddp: " + "; ".join(problems))
    # the probe's features gathered in rank order against one rank's
    feats, labels = one["probe"]["feats"], one["probe"]["labels"]
    n = feats.shape[0]
    order = np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)])
    for r in (0, 1):
        if not np.array_equal(b[r]["probe"]["labels"], labels[order]):
            fail(f"ddp (b) rank {r}: the probe's gathered labels are not in rank order")
    f_err = float(np.abs(b[0]["probe"]["feats"] - feats[order]).max())
    print(f"[ddp] (b) probe features ({n}, {feats.shape[1]}) gathered in rank "
          f"order against one rank's: max |diff| {f_err} (tolerance {FEAT_ATOL})", flush=True)
    if f_err > FEAT_ATOL or not np.array_equal(b[0]["probe"]["feats"], b[1]["probe"]["feats"]):
        fail("ddp (b): the probe's gathered features differ")
    # the held f32 steps' host times on each leg (each alone on the card), and the
    # gradient all-reduce's
    for model, tag, bs in (("ft", "finetune", 32), ("s2", "Stage-II", 128), ("s1", "Stage-I", 64),
                           ("ps", "part-seg", SEG_PART_B), ("ss", "sem-seg", SEG_SEM_B),
                           ("pb", "PointBERT", 128)):
        for who, res, ranks in (("no group", one, 1), ("NCCL, 1 rank", a, 1),
                                ("gloo rank 0", b[0], 2), ("gloo rank 1", b[1], 2)):
            if model not in res:
                continue
            t = res[model]
            med = statistics.median(t["step_ms"][1:])
            share = ("" if t["reduce_ms"] is None else
                     f"; the gradient all-reduce alone {t['reduce_ms']:.3f} ms host, "
                     f"{t['reduce_ms'] / med:.3f} of a step")
            print(f"[time] ddp {tag} f32 step, B={bs // ranks} a rank, {who}: host ms "
                  f"{[round(x, 3) for x in t['step_ms']]}, median after the first "
                  f"{med:.3f}{share}", flush=True)
    print(f"[ddp] gradient all-reduce a step: finetune {b[0]['ft']['grad_mb']:.1f} MB, Stage II "
          f"{b[0]['s2']['grad_mb']:.1f} MB, part seg {b[0]['ps']['grad_mb']:.1f} MB, sem seg "
          f"{b[0]['ss']['grad_mb']:.1f} MB, PointBERT {b[0]['pb']['grad_mb']:.1f} MB of f32 (the "
          f"trainable tensors)", flush=True)
    print(f"[ddp] phase 38 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {}, errs, launches


def ddp_runs(tmp: str) -> None:
    """The ``run_net`` legs of phase 38 (``chip_smoke.py --ddp-runs TMP``),
    checked and not timed, beside phase 37's tracing: finetune and Stage-II
    ``run_net`` without a group, then the same in an NCCL group of this one
    rank (leg (a)), then leg (c)'s Stage II stopped by the step hook and
    resumed (``ddp_preempt_stage2``); writes the epoch losses to
    ``runs.pt``. Exits non-zero if a run fails."""
    import torch
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from act_tpu_torch.datasets import pointcloud_datasets
    from act_tpu_torch.ops import _backend
    dev = _backend.resolve_device("cuda")
    _backend.build_kernels()
    pointcloud_datasets.ModelNet.synthetic_len = DDP_FT_CLOUDS  # as leg (c)'s CLI
    t0 = time.perf_counter()
    out = {"one": ddp_run_nets(dev, tmp, "one")}
    with one_nccl_rank():
        out["a"] = ddp_run_nets(dev, tmp, "a")
    ddp_preempt_stage2(dev, tmp)
    torch.save(out, os.path.join(tmp, "runs.pt"))
    print(f"[ddp] run_net legs (beside phase 37's tracing): {time.perf_counter() - t0:.1f} s",
          flush=True)


def ddp_run_net_check(tmp, side) -> None:
    """Leg (a)'s ``run_net``s (finetune and Stage II over NCCL) bit-equal to
    the same without a group (``ddp_runs``, in ``tmp``)."""
    import torch
    rc = side.get("runs")
    if rc != 0:
        fail(f"ddp: the run_net legs failed (exit {rc})")
    runs = torch.load(os.path.join(tmp, "runs.pt"), weights_only=False)
    a, one = runs["a"], runs["one"]
    # run_net with and without the group
    for model, tag in (("ft", "finetune"), ("s2", "Stage-II")):
        pa = torch.load(os.path.join(tmp, f"{model}-a", "ckpt-last.pth"), weights_only=True)
        po = torch.load(os.path.join(tmp, f"{model}-one", "ckpt-last.pth"), weights_only=True)
        same = all(torch.equal(t, po["base_model"][k]) for k, t in pa["base_model"].items())
        same &= a[f"{model}_loss"] == one[f"{model}_loss"]
        print(f"[ddp] (a) {tag} run_net over NCCL: {pa['step']} steps, epoch loss "
              f"{a[f'{model}_loss']}; weights and statistics bit-equal to the run "
              f"without a group: {same}", flush=True)
        if not same:
            fail(f"ddp (a) {tag} run_net differs from the run without a group")


def ddp_side_start(tmp, started):
    """Start phase 38's checked, untimed work on a thread, in ``tmp`` (it
    runs beside phase 37's tracing): the ``run_net`` legs (``ddp_runs``, a
    process of their own), leg (c)'s finetune CLI for one epoch of
    ``DDP_FT_CLOUDS`` clouds (``--scratch_model``) stopped by a real SIGTERM
    after step ``PREEMPT_AT`` and then ``--resume``d to the epoch's end, leg
    (d)'s part-seg CLI under ``torch.distributed.run`` with 2 ranks on the
    card (``SEG_CLI_STEPS`` steps), and beside it leg (t)'s finetune CLI
    under ``torch.distributed.run`` at ``--mesh_model_parallel 2``
    (``TP_CLI_STEPS`` steps; its output to ``tp_cli.log``); each process
    appended to ``started``. Returns {"thread", and once it ends "cut",
    "rest" (each the CLI's exit code, output lines and seconds), "seg" and
    "tp" (each torchrun process's exit code, output and seconds, the TP
    CLI's until the seg CLI's end), "runs" (the run_net legs' exit code)}."""
    import signal
    cfg_dir = os.path.join(tmp, "cfgs", "full")
    os.makedirs(cfg_dir)
    with open(os.path.join(ROOT, CONFIG)) as f:
        text = f.read().replace("max_epoch: 300", "max_epoch: 1")
    text = text.replace("  depth: 12\n", f"  depth: {CUT_DEPTH}\n")  # as cut_depth
    text = text.replace("_base_: cfgs/", f"_base_: {ROOT}/cfgs/")
    yaml = os.path.join(cfg_dir, "finetune_modelnet.yaml")
    with open(yaml, "w") as f:
        f.write(text)
    wrapper, tp_wrapper = os.path.join(tmp, "seg_cli.py"), os.path.join(tmp, "tp_cli.py")
    with open(wrapper, "w") as f:
        f.write(SEG_CLI_WRAPPER)
    with open(tp_wrapper, "w") as f:
        f.write(TP_CLI_WRAPPER)
    env, side = {**os.environ, "ACT_ROOT": ROOT, DDP_FT_ENV: str(DDP_FT_CLOUDS)}, {}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)

    def cli(exp, stop_at=0, *flags):
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", CLI_WRAPPER, str(stop_at), "--config",
                                 yaml, "--scratch_model", "--exp_name", exp, "--device",
                                 DDP_CLI_DEVICE, *flags], cwd=tmp,
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started.append(proc)
        lines = []
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("[ddp] step"):
                proc.send_signal(signal.SIGTERM)
        return proc.wait(timeout=600), lines, time.perf_counter() - t0

    def run():
        t0 = time.perf_counter()
        runs = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-runs", tmp],
                                cwd=ROOT, env=env)
        started.append(runs)
        seg = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
             wrapper, DDP_B[0], DDP_B[1], "--device", DDP_B[0],
             "--steps", str(SEG_CLI_STEPS), "--epoch", "1", "--batch_size", str(SEG_PART_B),
             "--npoint", str(SEG_NPOINT), "--root", "no_data", "--log_dir", "ddp",
             "--num_workers", "0"], cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        started.append(seg)
        tp_log, t_tp = open(os.path.join(tmp, "tp_cli.log"), "w+"), time.perf_counter()
        tp_run = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
             tp_wrapper, DDP_B[0], DDP_B[1], "--config", yaml, "--finetune_model",
             "--mesh_model_parallel", str(DDP_TP), "--exp_name", "tp", "--device", DDP_B[0],
             "--num_workers", "0"], cwd=tmp, env=env, stdout=tp_log, stderr=subprocess.STDOUT)
        started.append(tp_run)
        try:
            side["cut"] = cli("cut", PREEMPT_AT)
            side["rest"] = cli("cut", 0, "--resume")
        finally:
            out = seg.communicate(timeout=600)[0]
            side["seg"] = (seg.returncode, out, time.perf_counter() - t0)
            rc = tp_run.wait(timeout=600)
            tp_log.seek(0)
            side["tp"] = (rc, tp_log.read(), time.perf_counter() - t_tp)
            tp_log.close()
            side["runs"] = runs.wait(timeout=600)
    side["thread"] = threading.Thread(target=run, daemon=True)
    side["thread"].start()
    return side


def ddp_preempt_stage2(dev, tmp) -> None:
    """Leg (c)'s Stage II: ``run_net`` stopped by the step hook
    (``GUARD.at_step``) after step ``PREEMPT_AT`` and resumed, bit-equal to the
    uninterrupted ``run_net`` of this process."""
    import torch
    from act_tpu_torch.engine import runner_pretrain as rp
    from act_tpu_torch.engine.preemption import GUARD
    path = os.path.join(tmp, "s2-cut")
    GUARD.reset()
    GUARD.at_step = PREEMPT_AT
    try:
        t0 = time.perf_counter()
        cut = rp.run_net(ddp_pretrain_config(), device=dev, epochs=1,
                         allow_random_tokenizer=True, experiment_path=path)
        s_cut = time.perf_counter() - t0
    finally:
        GUARD.reset()
        GUARD.at_step = None
    if not cut.preempted or cut.step != PREEMPT_AT:
        fail(f"ddp (c): Stage II did not stop at step {PREEMPT_AT}")
    rest = rp.run_net(ddp_pretrain_config(), device=dev, epochs=1, allow_random_tokenizer=True,
                      resume=True, experiment_path=path)
    pw = torch.load(os.path.join(tmp, "s2-one", "ckpt-last.pth"), weights_only=True)
    pr = torch.load(os.path.join(path, "ckpt-last.pth"), weights_only=True)
    same = pr["step"] == pw["step"] and all(
        torch.equal(t, pr["base_model"][k]) for k, t in pw["base_model"].items())
    print(f"[ddp] (c) Stage II stopped by the step hook at step {cut.step} ({s_cut:.1f} s), "
          f"resumed to step {rest.step}: weights and statistics bit-equal to the uninterrupted "
          f"run: {same}", flush=True)
    if not same:
        fail("ddp (c): the resumed Stage II differs from the uninterrupted run")


def ddp_preempt_check(tmp, side) -> None:
    """Leg (c)'s finetune CLI: the cut run exits 0 after a ``[PREEMPT]`` line
    with ckpt-last holding its cursor; the ``--resume``d run re-enters the
    epoch and ends bit-equal to the uninterrupted ``run_net`` of this process
    (the CLI runs that same call: seed 0, one epoch, no pretrained weights)."""
    import re

    import torch
    for key, flags in (("cut", ""), ("rest", " --resume")):
        if key not in side:
            fail(f"ddp (c): the finetune CLI{flags} did not run")
        rc, lines, _ = side[key]
        if rc != 0:
            print("\n".join(lines[-40:]), flush=True)
            fail(f"ddp (c) finetune CLI{flags}: exit {rc}")
    (_, cut, s_cut), (_, rest, s_rest) = side["cut"], side["rest"]
    exp_dir = os.path.join(tmp, "work_dirs", "finetune_modelnet", "full")
    pre = [ln for ln in cut if "[PREEMPT]" in ln]
    saved = [ln for ln in cut if "Saved checkpoint" in ln]
    if not pre or not saved:
        print("\n".join(cut[-40:]), flush=True)
        fail("ddp (c): the finetune CLI did not stop with a [PREEMPT] save")
    print(f"[ddp] (c) finetune CLI stopped by SIGTERM after step {PREEMPT_AT}: exit 0, "
          f"{pre[-1]}; {saved[-1]}; run {s_cut:.1f} s", flush=True)
    size = re.search(r"\(([0-9.]+) MiB, ([0-9.]+) s\)", saved[-1])
    print(f"[time] ddp preemption save: {size.group(1)} MiB, {size.group(2)} s host (finetune "
          f"ckpt-last with the cursor; contended: the CLI ran beside phase 37's tracing and "
          f"the part-seg CLI)", flush=True)
    if not any("resumed mid-epoch 0 at batch" in ln for ln in rest):
        fail("ddp (c): --resume did not re-enter the interrupted epoch")
    pw = torch.load(os.path.join(tmp, "ft-one", "ckpt-last.pth"), weights_only=True)
    pr = torch.load(os.path.join(exp_dir, "cut", "ckpt-last.pth"), weights_only=True)
    same = (pr["step"] == pw["step"] and "data_iter" not in pr and all(
        torch.equal(t, pr["base_model"][k]) for k, t in pw["base_model"].items()))
    print(f"[ddp] (c) finetune --resume: {pr['step']} steps, final weights and statistics "
          f"bit-equal to the uninterrupted run: {same} ({s_rest:.1f} s)", flush=True)
    if not same:
        fail("ddp (c): the resumed finetune differs from the uninterrupted run")


# runs ``act_tpu_torch.main`` with argv[3:] in a process group of device argv[1]
# and backend argv[2] made first, its finetune ``run_net`` capped at 2 steps an epoch,
# on DDP_FT_CLOUDS synthetic ModelNet clouds
TP_CLI_WRAPPER = r"""
import functools, os, sys
sys.path.insert(0, os.environ["ACT_ROOT"])
from act_tpu_torch.datasets import pointcloud_datasets
pointcloud_datasets.ModelNet.synthetic_len = int(os.environ["CHIP_SMOKE_FT_CLOUDS"])
from act_tpu_torch import parallel
parallel.initialize_distributed(sys.argv[1], backend=sys.argv[2])
from act_tpu_torch import main
from act_tpu_torch.engine import runner_finetune
runner_finetune.run_net = functools.partial(runner_finetune.run_net, max_steps=2)
main.main(sys.argv[3:])
"""
TP_CLI_STEPS = 2


# runs ``act_tpu_torch.part_segmentation`` with argv[3:] in a process group of
# device argv[1] and backend argv[2] made first (two ranks share the one card: NCCL
# takes one rank a card, so they join over gloo), its backbone at CUT_SEG_WIDTHS
SEG_CLI_WRAPPER = r"""
import functools, os, sys
sys.path.insert(0, os.environ["ACT_ROOT"])
from act_tpu_torch import parallel
parallel.initialize_distributed(sys.argv[1], backend=sys.argv[2])
from act_tpu_torch import part_segmentation
from act_tpu_torch.engine import runner_segmentation as rs
rs.build_seg_state = functools.partial(rs.build_seg_state, widths=%r)
part_segmentation.main(sys.argv[3:])
""" % CUT_SEG_WIDTHS


def ddp_tp_cli_check(tmp, side) -> None:
    """Leg (t)'s CLI: the finetune CLI under ``torch.distributed.run`` with 2
    ranks on the card at ``--mesh_model_parallel 2`` (one epoch of
    ``TP_CLI_STEPS`` steps, its validation) exits 0, and its ckpt-best loads
    with ``strict=True`` into a model without a group."""
    import torch
    from act_tpu_torch.engine import runner_finetune as rf
    from act_tpu_torch.models import MODELS
    if "tp" not in side:
        fail("ddp (t): the tensor-parallel finetune CLI did not run")
    rc, out, secs = side["tp"]
    path = os.path.join(tmp, "work_dirs", "finetune_modelnet", "full", "tp", "ckpt-best.pth")
    if rc != 0 or not os.path.exists(path):
        print(out[-3000:], flush=True)
        fail(f"ddp (t): the finetune CLI at --mesh_model_parallel {DDP_TP} exited {rc} "
             f"without a ckpt-best")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model = MODELS.build(cut_depth(rf.finetune_config(CONFIG)).model)
    model.load_state_dict(payload["base_model"], strict=True)
    print(f"[ddp] (t) finetune CLI under torch.distributed.run, 2 ranks at "
          f"--mesh_model_parallel {DDP_TP} on one card over {DDP_B[1]}: exit {rc}, done within "
          f"{secs:.1f} s (beside phase 37's tracing and the part-seg CLI); its ckpt-best (step {payload['step']}) loads "
          f"strictly into a model without a group", flush=True)
    if payload["step"] != TP_CLI_STEPS:
        fail(f"ddp (t): the CLI's ckpt-best is at step {payload['step']}, not {TP_CLI_STEPS}")


def ddp_seg_cli_check(tmp, side) -> None:
    """Leg (d): the part-seg CLI under ``torch.distributed.run`` with 2 ranks
    on the card (``--steps SEG_CLI_STEPS``: as many steps of the global B=16
    and evaluation batches) wrote exactly one ckpt-best and one log; the
    whole-scene CLI with torchrun's ``WORLD_SIZE`` of 2 raises before it
    loads anything."""
    import torch
    from act_tpu_torch import semantic_segmentation_test
    if "seg" not in side:
        fail("ddp (d): the part-seg CLI did not run")
    rc, out, secs = side["seg"]
    exp = os.path.join(tmp, "work_dirs", "part_seg", "ddp")
    files = sorted(os.listdir(exp)) if os.path.isdir(exp) else []
    print(f"[ddp] (d) part-seg CLI under torch.distributed.run, 2 ranks on one card over "
          f"{DDP_B[1]}: exit {rc}, {secs:.1f} s (beside phase 37's tracing); "
          f"its directory holds {files}", flush=True)
    if rc != 0 or files != ["ckpt-best.pth", "train.log"]:
        print(out[-3000:], flush=True)
        fail("ddp (d): the 2-rank part-seg CLI did not write exactly one ckpt-best and one log")
    steps = torch.load(os.path.join(exp, "ckpt-best.pth"), weights_only=True)["step"]
    if steps != SEG_CLI_STEPS:
        fail(f"ddp (d): the part-seg CLI's ckpt-best is at step {steps}, not {SEG_CLI_STEPS}")
    os.environ["WORLD_SIZE"] = "2"
    try:
        semantic_segmentation_test.main(["--root", os.path.join(tmp, "no_data")])
        said = None
    except RuntimeError as e:
        said = str(e)
    finally:
        del os.environ["WORLD_SIZE"]
    print(f"[ddp] (d) whole-scene CLI with WORLD_SIZE 2: raises {said!r}", flush=True)
    if said != semantic_segmentation_test.WHOLE_SCENE_RANKS:
        fail("ddp (d): the whole-scene CLI did not refuse 2 ranks")


# the phases that run in a child process of their own (``chip_smoke.py FLAG OUT``),
# where the profiler's windows are whole
CHILD_PHASES = {"--pointbert": "pointbert", "--tokenizer": "tokenizer", "--tsne": "tsne",
                "--export": "export", "--ddp": "ddp", "--modelnet8k": "modelnet8k",
                "--parity": "parity", "--plain-dvae": "plain_dvae",
                "--plain-dvae-cli": "plain_dvae_cli", "--flops": "flops",
                "--dvae-tsne": "dvae_tsne", "--profile": "profiled", "--bench": "bench_tools"}


def stop_processes(procs) -> None:
    """Stop each process of ``procs`` still running (SIGTERM, which
    ``torch.distributed.run`` passes to its ranks, then SIGKILL after 30 s)."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def start_child(flag, env=None):
    """Start the phases of ``flag`` in a child process (``chip_smoke.py FLAG
    OUT``, with ``env`` added to the environment): late windows of a long
    process come back incomplete, and heavy windows would cost the later
    phases theirs. The child loads the kernels this process built and writes
    its timing rows, errors and launch counts to OUT. Returns what
    ``finish_child`` takes."""
    import tempfile
    import torch
    torch.cuda.empty_cache()
    sys.stdout.flush()
    fd, out = tempfile.mkstemp(prefix="chip_smoke_child_", suffix=".json")
    os.close(fd)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, out], cwd=ROOT,
                            env={**os.environ, **(env or {})})
    return proc, flag, out


def finish_child(started, timeout=600):
    """Wait for a child of ``start_child``; fails if it fails or outlasts
    ``timeout`` s. Returns its timing rows, errors and launches."""
    proc, flag, out = started
    try:
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            stop_processes([proc])
            fail(f"the {CHILD_PHASES[flag]} phases did not end within {timeout} s")
        if rc != 0:
            fail(f"the {CHILD_PHASES[flag]} phases failed (exit {rc})")
        with open(out) as f:
            got = json.load(f)
    finally:
        os.remove(out)
    return got["rows"], got["errs"], got["launches"]


def in_child(flag, timeout=600, env=None):
    """The phases of ``flag`` in a child process, waited for."""
    return finish_child(start_child(flag, env), timeout)


def child(flag: str, out: str) -> None:
    """The child of ``in_child``: the phases of ``flag`` on the card."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from act_tpu_torch.ops import _backend
    from act_tpu_torch.profiling import device_ms, kernel_events
    dev = _backend.resolve_device("cuda")
    _backend.build_kernels()
    phases = globals()[CHILD_PHASES[flag]]
    rows, errs, launches = phases(dev, device_ms, kernel_events, measure)
    with open(out, "w") as f:
        json.dump({"rows": rows, "errs": errs, "launches": launches}, f, allow_nan=False)


def main() -> None:
    t_start = time.perf_counter()
    import tempfile

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from act_tpu_torch import ops
        from act_tpu_torch.engine.serve import build_infer_fn, load_config, load_model
        from act_tpu_torch.ops import _backend, work
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

    # -- 5. times on the card (``measure``) -----------------------------------
    print(f"[time] card: {card}", flush=True)

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
                                 work.fps(B, N_IN, npoints))),
                measure(f"(1, {N_IN}, 3)->{npoints} (B=1 request)",
                        lambda: ops.furthest_point_sample(one, npoints),
                        lambda: ops.furthest_point_sample_ref(one, npoints), None, 20, 1,
                        bound_ms(one.numel() * 4 + npoints * 4,
                                 work.fps(1, N_IN, npoints))),
                measure(f"({B}, {npoints}, 3)->{G}",
                        lambda: ops.furthest_point_sample(d_pts, G),
                        lambda: ops.furthest_point_sample_ref(d_pts, G), None, 50, 3,
                        bound_ms(d_pts.numel() * 4 + B * G * 4,
                                 work.fps(B, npoints, G))),
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

    for bs, iters in ((1, 30), (B, 20)):
        lat = request_ms(lambda: infer(clouds[:bs]), iters)
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
    print(f"[time] phases 1-5, 19 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(c_errs)
    # -- 25-28. part and semantic segmentation, also while windows are whole ---------
    seg_rows, seg_errs, seg_launches = segmentation(dev, device_ms, kernel_events, measure)
    print(f"[time] phases 25-28 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(seg_errs)

    # -- 6-10. Stage-II pretraining ----------------------------------------------
    stage2, s2_errs, s2_launches = stage_two(dev, device_ms, kernel_events, measure)
    print(f"[time] phases 6-10 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(s2_errs)
    # -- 11-14. Stage-I autoencoder training and its metrics ------------------------
    stage1, s1_errs, s1_launches, val_launches = stage_one(dev, device_ms, kernel_events,
                                                           measure)
    print(f"[time] phases 11-14 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(s1_errs)
    # -- 15-18. classification finetune, validation and the vote ------------------
    ft_rows, ft_errs, ft_launches = finetune(dev, device_ms, kernel_events, measure)
    print(f"[time] phases 15-18 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(ft_errs)
    # -- 20-24. the Stage-I -> Stage-II -> finetune chain and the loader ---------
    chain_runs, chain_errs = chain(dev)
    print(f"[time] phases 20-24 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(chain_errs)
    # -- 29-32. ACT_PointBERT, in a process of its own (its profiler windows whole)
    pb_rows, pb_errs, pb_launches = in_child("--pointbert")
    print(f"[time] phases 29-32 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(pb_errs)
    # -- 33-35. the dVAE tokenizer served, the CLIP and BERT teachers, a process of their own
    tk_rows, tk_errs, tk_launches = in_child("--tokenizer")
    print(f"[time] phases 33-35 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(tk_errs)
    # -- 39-41. ModelNet40 at 8192 points (the FPS cache, the 8k configs) and the
    # trainer options, a process of their own
    m8_rows, m8_errs, m8_launches = in_child("--modelnet8k")
    print(f"[time] phases 39-41 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(m8_errs)
    # -- 43. Point-BERT's plain dVAE, then 36. t-SNE: a process of their own, each alone
    ref = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_tsne_ref_"), "feats.npz")
    dt_rows, dt_errs, dt_launches = in_child("--dvae-tsne", env={TSNE_REF_ENV: ref})
    ts_rows, pd_launches, ts_launches = dt_rows["tsne"], dt_launches["plain_dvae"], dt_launches[
        "tsne"]
    ref_data = dict(np.load(ref))
    shutil.rmtree(os.path.dirname(ref), ignore_errors=True)
    print(f"[time] phases 43 and 36 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(dt_errs)
    # -- 47. the per-op profile of the Stage-II step, run_net's trace window and
    # random_dropping, a process of their own (its profiler windows whole)
    _, pr_errs, pr_launches = in_child("--profile")
    print(f"[time] phase 47 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(pr_errs)
    # -- 48. the measurement tools (bench, bench_suite, bench_sustained, graft_entry),
    # a process of its own
    _, bn_errs, bn_launches = in_child("--bench")
    print(f"[time] phase 48 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(bn_errs)
    # -- 37. the exported artifacts, in a process of its own. Beside its tracing run
    # what is checked and not timed: phase 36's CPU t-SNE reference on a thread here,
    # phase 38's CLIs (legs (c) and (d)) and its run_net legs (``ddp_runs``); its
    # timed requests wait for them to end
    ddp_dir, side_procs = tempfile.mkdtemp(prefix="chip_smoke_ddp_"), []
    try:
        tsne_ref = {}
        tsne_thread = threading.Thread(target=lambda: tsne_ref.update(
            done=tsne_cpu_check(ref_data["feats"], float(ref_data["kl"])) or True), daemon=True)
        tsne_thread.start()
        side = ddp_side_start(ddp_dir, side_procs)
        # phase 38's process starts now: it starts leg (b)'s ranks, and all wait for
        # phase 37's end before their timed steps
        ddp_child = start_child("--ddp", env={DDP_TMP_ENV: ddp_dir})
        side_procs.append(ddp_child[0])
        # -- 42 and 46. the MODEL_ZOO parity protocol and the finetune variants, 44. the
        # plain dVAE's CLI and its checkpoint served, 45. get_flops on every shipped model
        # YAML: checked and untimed, beside the tracing
        beside = {flag: start_child(flag) for flag in ("--parity", "--plain-dvae-cli",
                                                       "--flops")}
        side_procs += [c[0] for c in beside.values()]
        quiet = os.path.join(ddp_dir, "quiet")

        def when_quiet():  # the side work has ended; phase 38's processes wait, warmed up
            tsne_thread.join()
            side["thread"].join()
            for c in beside.values():
                c[0].wait()
            ready = [os.path.join(ddp_dir, f"ready-{w}") for w in ("b-0", "b-1", "one")]
            while ddp_child[0].poll() is None and not all(map(os.path.exists, ready)):
                time.sleep(0.2)
            open(quiet, "w").close()
        threading.Thread(target=when_quiet, daemon=True).start()
        ex_rows, ex_errs, ex_launches = in_child("--export", timeout=1000,
                                                 env={QUIET_ENV: quiet})
        print(f"[time] phase 37 done at {time.perf_counter() - t_start:.1f} s", flush=True)
        errs.update(ex_errs)
        if not tsne_ref.get("done"):
            fail("phase 36's CPU t-SNE reference failed")
        _, par_errs, par_launches = finish_child(beside["--parity"], timeout=600)
        _, _, pd_cli_launches = finish_child(beside["--plain-dvae-cli"], timeout=600)
        _, _, fl_launches = finish_child(beside["--flops"], timeout=600)
        print(f"[time] phases 42, 44-46 done at {time.perf_counter() - t_start:.1f} s (beside "
              "phase 37's tracing)", flush=True)
        errs.update(par_errs)
        # -- 38. data parallelism over ranks and preemption
        open(os.path.join(ddp_dir, "go"), "w").close()
        _, ddp_errs, ddp_launches = finish_child(ddp_child, timeout=900)
        ddp_run_net_check(ddp_dir, side)
        ddp_preempt_check(ddp_dir, side)
        ddp_seg_cli_check(ddp_dir, side)
        ddp_tp_cli_check(ddp_dir, side)
    finally:
        stop_processes(side_procs)
        shutil.rmtree(ddp_dir, ignore_errors=True)
    print(f"[time] phase 38 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    errs.update(ddp_errs)
    # kernel -> (its path, the path's timing rows, the launches of its run)
    paths = {k: ("pretrain", stage2, s2_launches) for k in STAGE2_PER_STEP}
    paths.update({k: ("autoencoder", stage1, s1_launches) for k in ("chamfer_nn", "chamfer_bwd")})
    paths["chamfer_nn_min"] = ("validate (a unit is one cloud)", stage1, val_launches)
    paths["row_gather_bwd"] = ("autoencoder", stage1, s1_launches)

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
            "launches_seg": {tag: n[kernel] for tag, n in seg_launches.items()},
            "launches_pointbert": {tag: n[kernel] for tag, n in pb_launches.items()},
            "launches_tokenizer": {tag: n[kernel] for tag, n in tk_launches.items()},
            "launches_modelnet8k": {tag: n[kernel] for tag, n in m8_launches.items()},
            "launches_tsne": {tag: n[kernel] for tag, n in ts_launches.items()},
            "launches_export": {tag: n[kernel] for tag, n in ex_launches.items()},
            "launches_ddp": {tag: n[kernel] for tag, n in ddp_launches.items()},
            "launches_parity": {tag: n[kernel] for tag, n in par_launches.items()},
            "launches_plain_dvae": {tag: n[kernel] for tag, n in pd_launches.items()},
            "launches_plain_dvae_cli": {tag: n[kernel] for tag, n in pd_cli_launches.items()},
            "launches_flops": {tag: n[kernel] for tag, n in fl_launches.items()},
            "launches_profile": {tag: n[kernel] for tag, n in pr_launches.items()},
            "launches_bench": {tag: n[kernel] for tag, n in bn_launches.items()},
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
                                                ("chain", chain_rows.get(kernel, [])),
                                                ("segmentation", seg_rows.get(kernel, [])),
                                                ("pointbert", pb_rows.get(kernel, [])),
                                                ("tokenizer", tk_rows.get(kernel, [])),
                                                ("modelnet8k", m8_rows.get(kernel, [])),
                                                ("tsne", ts_rows.get(kernel, [])),
                                                ("export", ex_rows.get(kernel, [])))
                           for r in group],
        }

    print(f"[time] chip_smoke.py {time.perf_counter() - t_start:.1f} s in all", flush=True)
    record = [row_entry(name, name, REPLACES[name]) for name in REPLACES]
    record += [row_entry(name, kernel, rep) for name, (kernel, rep) in COVERED.items()]
    print(json.dumps({"kernels": record}, allow_nan=False), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1] in CHILD_PHASES:
        child(sys.argv[1], sys.argv[2])
    elif sys.argv[1:2] == ["--artifacts"]:
        artifacts_child(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--ddp-rank"]:
        ddp_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--ddp-runs"]:
        ddp_runs(sys.argv[2])
    else:
        main()
