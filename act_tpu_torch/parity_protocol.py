"""The MODEL_ZOO parity protocol on the port: one command per zoo row.

Counterpart of ``tools/parity_protocol.py``: its task tables and zoo numbers,
its flags, legs, result dict and table, with the JSON line last on stdout.
The port reads the released ``.pth`` as it is, with no conversion step:
``engine/serve.load_state_dict`` takes ``base_model`` / ``model_state_dict``
and strips DDP's ``module.``; the S3DIS file's head keys of either layout
load through ``weights.seg_reference_keys``; a pretrain file's student is
lifted by ``strip_student_prefix``. Every model the protocol evaluates is
loaded strictly; a pretrain file must hold every backbone key of the
finetune model it starts.

    python -m act_tpu_torch.parity_protocol --task scan_hardest --ckpt ckpt_scan_hardest.pth --vote
    python -m act_tpu_torch.parity_protocol --task modelnet --ckpt ckpt_pretrain.pth --from_pretrain
    python -m act_tpu_torch.parity_protocol --task s3dis --ckpt s3dis_best.pth
    python -m act_tpu_torch.parity_protocol --task fewshot_modelnet_5w10s --ckpt ckpt_pretrain.pth
    python -m act_tpu_torch.parity_protocol --task dvae --ckpt ckpt_dvae.pth

The legs: the classification test (and the best of ``--vote_rounds`` vote
rounds, 300 by default) in f32; ``--from_pretrain``: the finetune of the
config, then the test of its ckpt-best; S3DIS: the whole-scene vote mIoU in
f32 (``--vote_rounds`` rounds, 3 by default); few-shot: each fold
finetuned with its way/shot/fold, its best OA read from its ckpt-best (a
fold without one is skipped), mean and std over the folds; dVAE: the
CDL1/CDL2/F-score table of the val split in f32, the config's teacher arch
checked against ``--teacher_arch``. The f32 legs run with TF32 off.

The JAX tool's ``--smoke`` shrinks the model; the port has none. Its bounds
cut length only, never width: ``--max_batches`` (test batches; S3DIS
scenes; dVAE validation clouds), ``--vote_rounds``, ``--folds``,
``--epochs`` and ``--max_steps`` (finetune epochs and the steps of each).
The finetunes run in ``<--work_dir>/parity/<exp_name>`` (``./work_dirs`` by
default). The protocol runs on the card unless ``--device cpu`` is given,
and raises without one; the data fall back to the synthetic clouds when the
configured roots are absent.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from contextlib import contextmanager
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from act_tpu_torch.engine import checkpoint as ckpt_lib
from act_tpu_torch.engine import runner_autoencoder, runner_finetune, runner_segmentation
from act_tpu_torch.engine.serve import load_config, load_state_dict
from act_tpu_torch.engine.weights import seg_reference_keys
from act_tpu_torch.models import MODELS
from act_tpu_torch.ops import resolve_device

# MODEL_ZOO.md rows: task -> (finetune config, released OA %)
TASKS = {
    "scan_hardest": ("cfgs/finetune_classification/full/finetune_scan_hardest.yaml", 88.21),
    "scan_objbg": ("cfgs/finetune_classification/full/finetune_scan_objbg.yaml", 93.29),
    "scan_objonly": ("cfgs/finetune_classification/full/finetune_scan_objonly.yaml", 91.91),
    "modelnet": ("cfgs/finetune_classification/full/finetune_modelnet.yaml", 93.70),
}
# MODEL_ZOO.md:16, the released S3DIS semantic-seg checkpoint: whole-scene vote mIoU %
SEG_TASKS = {"s3dis": 61.2}
# MODEL_ZOO.md:8, the released Stage-I autoencoder: no accuracy (N/A); the
# per-taxonomy CDL1/CDL2/F-score table is reported as it is
DVAE_TASKS = {"dvae": "cfgs/autoencoder/act_dvae_with_pretrained_transformer.yaml"}
# MODEL_ZOO.md:21-23 few-shot rows: task -> (way, shot, zoo mean acc %), from the
# released Stage-II pretrain checkpoint, 10 folds
FEWSHOT_TASKS = {
    "fewshot_modelnet_5w10s": (5, 10, 96.8),
    "fewshot_modelnet_5w20s": (5, 20, 98.0),
    "fewshot_modelnet_10w10s": (10, 10, 93.3),
    "fewshot_modelnet_10w20s": (10, 20, 95.6),
}
FEWSHOT_CFG = "cfgs/finetune_classification/few_shot/fewshot_modelnet.yaml"
FOLDS = 10
TEST_VOTE_ROUNDS, SCENE_VOTE_ROUNDS = 300, 3
S3DIS_ROOT = "data/stanford_indoor3d"
HEAD_KEYS = ("cls_head_finetune.",)  # the finetune model's keys a pretrain file lacks
ARCH_OF = {"ACTPromptedDiscreteVAEwithVIT": "vit", "ACTPromptedDiscreteVAEwithBERT": "bert"}


def _rewrite_data_root(config, data_root: str) -> None:
    """Point every dataset path key at ``data_root`` instead of ./data."""
    def walk(node):
        if not hasattr(node, "items"):
            return
        for k, v in list(node.items()):
            if k in ("ROOT", "DATA_PATH", "PC_PATH") and isinstance(v, str):
                node[k] = os.path.join(data_root, os.path.relpath(v, "data"))
            elif hasattr(v, "items"):
                walk(v)
    walk(config.dataset)


@contextmanager
def f32_eval():
    """TF32 off for the matmuls and convolutions of an f32 evaluation."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _config(path: str, data_root: Optional[str], f32: bool):
    cfg = load_config(path)
    if data_root:
        _rewrite_data_root(cfg, data_root)
    if f32:
        cfg.model.dtype = "f32"
    return cfg


def pretrain_student(ckpt, cfg) -> Dict[str, torch.Tensor]:
    """The student of a released pretrain ``.pth`` (prefix lifted), checked
    to hold every backbone tensor of the finetune model of ``cfg`` at its
    shape; the head starts from the seed, as in the reference recipe."""
    sd = ckpt_lib.strip_student_prefix(load_state_dict(ckpt))
    with torch.device("meta"):
        want = MODELS.build(cfg.model).state_dict()
    missing = sorted(k for k in want if k not in sd and not k.startswith(HEAD_KEYS))
    if missing:
        raise KeyError(f"the pretrain checkpoint lacks {len(missing)} backbone tensors of "
                       f"{cfg.model.NAME}: {missing[:8]}")
    wrong = sorted(k for k in want if k in sd and tuple(sd[k].shape) != tuple(want[k].shape))
    if wrong:
        raise ValueError(f"the pretrain checkpoint's tensors have other shapes: {wrong[:8]}")
    return sd


def _result(task, cfg_path, zoo, ours, vote, from_pretrain, **extra):
    delta = None if zoo is None else ours - zoo
    return {"task": task, "config": cfg_path, "zoo_acc": zoo, "ours": ours, **extra,
            "delta": delta, "within_0.2": None if delta is None else abs(delta) <= 0.2,
            "vote": vote, "from_pretrain": from_pretrain}


def run_protocol(task: str, ckpt, vote: bool = False, from_pretrain: bool = False,
                 data_root: Optional[str] = None, exp_name: Optional[str] = None,
                 teacher_arch: str = "vit", device="cuda", max_batches: Optional[int] = None,
                 vote_rounds: Optional[int] = None, folds: Optional[Iterable[int]] = None,
                 epochs: Optional[int] = None, max_steps: Optional[int] = None,
                 seed: int = 0, work_dir: str = "./work_dirs") -> Dict:
    """One MODEL_ZOO row of the released ``ckpt`` (a ``.pth`` path or a
    mapping) on ``device``; returns the result dict of the JAX tool. The
    finetunes run in ``work_dir/parity/<exp_name>``."""
    dev = resolve_device(device)
    exp_name = exp_name or f"parity_{task}"
    exp_dir = os.path.join(work_dir, "parity", exp_name)
    if task in DVAE_TASKS:
        return _run_dvae(task, ckpt, data_root, teacher_arch, dev, max_batches, seed)
    if task in SEG_TASKS:
        return _run_seg(task, ckpt, data_root, dev, max_batches, vote_rounds, seed)
    if task in FEWSHOT_TASKS:
        return _run_fewshot(task, ckpt, data_root, exp_dir, dev, folds, epochs, max_steps,
                            seed)
    cfg_path, zoo = TASKS[task]
    rounds = TEST_VOTE_ROUNDS if vote_rounds is None else int(vote_rounds)
    if from_pretrain:
        cfg = _config(cfg_path, data_root, f32=False)  # the shipped training dtype
        runner_finetune.run_net(cfg, seed=seed, device=dev, epochs=epochs, max_steps=max_steps,
                                vote=vote, ckpts=pretrain_student(ckpt, cfg),
                                experiment_path=exp_dir)
        best = ckpt_lib.ckpt_path(exp_dir, "ckpt-best")
        if not os.path.exists(best):
            raise RuntimeError(f"the finetune wrote no ckpt-best under {exp_dir}")
        acc = runner_finetune.test_net(_config(cfg_path, data_root, f32=False), ckpts=best,
                                       seed=seed, device=dev, vote=vote, rounds=rounds,
                                       max_batches=max_batches, strict=True)
    else:
        with f32_eval():
            acc = runner_finetune.test_net(_config(cfg_path, data_root, f32=True),
                                           ckpts=load_state_dict(ckpt), seed=seed, device=dev,
                                           vote=vote, rounds=rounds, max_batches=max_batches,
                                           strict=True)
    ours = float(getattr(acc, "vote", 0.0) or acc.acc)
    return _result(task, cfg_path, zoo, ours, vote, from_pretrain)


def _run_seg(task, ckpt, data_root, dev, max_scenes, vote_rounds, seed) -> Dict:
    """Whole-scene vote mIoU of the released S3DIS checkpoint in f32
    (reference semantic_segmentation/main_test.py, MODEL_ZOO.md:16)."""
    root = os.path.join(data_root, "stanford_indoor3d") if data_root else S3DIS_ROOT
    with f32_eval():
        metrics, _ = runner_segmentation.whole_scene_eval(
            root=root, ckpts=seg_reference_keys(load_state_dict(ckpt)), dtype="f32",
            vote_num=SCENE_VOTE_ROUNDS if vote_rounds is None else int(vote_rounds),
            seed=seed, device=dev, max_scenes=max_scenes)
    return _result(task, "semantic_segmentation/main_test.py", SEG_TASKS[task],
                   metrics["mIoU"] * 100.0, True, False)


def _run_fewshot(task, ckpt, data_root, exp_dir, dev, folds, epochs, max_steps, seed) -> Dict:
    """Each fold finetuned from the released pretrain checkpoint with its
    way/shot/fold (reference main.py --way/--shot/--fold), its best
    validation OA read from its ckpt-best; mean and std over the folds."""
    way, shot, zoo = FEWSHOT_TASKS[task]
    accs = []
    for fold in (range(FOLDS) if folds is None else folds):
        cfg = runner_finetune.finetune_config(_config(FEWSHOT_CFG, data_root, f32=False),
                                              way, shot, fold)
        fold_dir = f"{exp_dir}_f{fold}"
        runner_finetune.run_net(cfg, seed=seed, device=dev, epochs=epochs, max_steps=max_steps,
                                ckpts=pretrain_student(ckpt, cfg), experiment_path=fold_dir,
                                way=way, shot=shot, fold=fold)
        best = ckpt_lib.ckpt_path(fold_dir, "ckpt-best")
        if not os.path.exists(best):
            # a fold that never beat OA 0 must not cost the others their runs
            print(f"[PARITY] fold {fold}: no ckpt-best written (degenerate run?); skipping "
                  "this fold", flush=True)
            continue
        accs.append(float(torch.load(best, map_location="cpu",
                                     weights_only=True)["best_metrics"]["acc"]))
        print(f"[PARITY] fold {fold}: best OA {accs[-1]:.2f}", flush=True)
    if not accs:
        raise RuntimeError("[PARITY] no fold produced a ckpt-best")
    return _result(task, FEWSHOT_CFG, zoo, float(np.mean(accs)), False, True,
                   std=float(np.std(accs)), folds=len(accs))


def _run_dvae(task, ckpt, data_root, teacher_arch, dev, max_batches, seed) -> Dict:
    """The released Stage-I checkpoint's CDL1/CDL2/F-score table over the
    val split in f32 (``--val``, reference tools/runner_autoencoder.py:219-323);
    the zoo publishes no number for it (MODEL_ZOO.md:8)."""
    cfg_path = DVAE_TASKS[task]
    cfg = _config(cfg_path, data_root, f32=True)
    cfg.model.frozen_bf16 = False  # the teacher in f32 too, as the JAX evaluation holds it
    name = str(cfg.model.NAME)
    expected = ARCH_OF.get(name)
    if expected is not None and teacher_arch != expected:
        raise SystemExit(f"--task {task} evaluates {name} ({cfg_path}); --teacher_arch "
                         f"{teacher_arch} does not match (expected {expected}). The released "
                         "Stage-I checkpoint is the prompted-ViT autoencoder (MODEL_ZOO.md:8).")
    with f32_eval():
        metrics = runner_autoencoder.validate_net(cfg, ckpts=load_state_dict(ckpt), seed=seed,
                                                  device=dev, max_batches=max_batches)
    table = metrics.state_dict()
    return _result(task, cfg_path, None, float(table.get("CDL2", math.nan)), False, False,
                   metrics={k: float(v) for k, v in table.items()})


def print_table(results) -> None:
    print("\n| task | config | zoo OA | ours | delta | within 0.2% |")
    print("|---|---|---|---|---|---|")
    for r in results:
        if r["zoo_acc"] is None:  # dvae: the table alone (the zoo's Acc is N/A)
            metric = " ".join(f"{k}={v:.4f}" for k, v in r.get("metrics", {}).items())
            print(f"| {r['task']} | {os.path.basename(r['config'])} | N/A | {metric} "
                  "| n/a | n/a |")
            continue
        print(f"| {r['task']} | {os.path.basename(r['config'])} | {r['zoo_acc']:.2f} "
              f"| {r['ours']:.2f} | {r['delta']:+.2f} | {'YES' if r['within_0.2'] else 'NO'} |")


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="the released .pth")
    ap.add_argument("--task", required=True,
                    choices=sorted(TASKS) + sorted(SEG_TASKS) + sorted(FEWSHOT_TASKS)
                    + sorted(DVAE_TASKS))
    ap.add_argument("--vote", action="store_true", help="the vote protocol (reference test :425)")
    ap.add_argument("--from_pretrain", action="store_true",
                    help="the ckpt is a Stage-II pretrain .pth: finetune first, then test")
    ap.add_argument("--data_root", default=None, help="dataset root replacing ./data")
    ap.add_argument("--exp_name", default=None)
    ap.add_argument("--teacher_arch", default="vit", choices=["vit", "clip", "bert"],
                    help="the teacher of the dvae row's checkpoint")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max_batches", type=int, default=None,
                    help="first test batches (S3DIS: scenes; dvae: validation clouds)")
    ap.add_argument("--vote_rounds", type=int, default=None,
                    help=f"vote rounds (default {TEST_VOTE_ROUNDS}; S3DIS {SCENE_VOTE_ROUNDS})")
    ap.add_argument("--folds", default=None, help="few-shot folds, e.g. 0 or 0,3 (default 0-9)")
    ap.add_argument("--epochs", type=int, default=None, help="finetune epochs (default the config's)")
    ap.add_argument("--max_steps", type=int, default=None, help="steps of each finetune epoch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work_dir", default="./work_dirs", help="the finetunes' runs go to "
                    "WORK_DIR/parity/EXP_NAME")
    args = ap.parse_args(argv)
    folds = None if args.folds is None else [int(f) for f in args.folds.split(",")]
    result = run_protocol(args.task, args.ckpt, vote=args.vote, from_pretrain=args.from_pretrain,
                          data_root=args.data_root, exp_name=args.exp_name,
                          teacher_arch=args.teacher_arch, device=args.device,
                          max_batches=args.max_batches, vote_rounds=args.vote_rounds,
                          folds=folds, epochs=args.epochs, max_steps=args.max_steps,
                          seed=args.seed, work_dir=args.work_dir)
    print_table([result])
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
