"""The flagship forward and the dry run over several ranks (counterpart of
``__graft_entry__.py``; a package module cannot carry that name).

``entry()`` returns ``(forward, (model, pts))``: the full-width
``ACT_PointDistillation`` of ``pretrain_act_distill.yaml`` (``pretrain_cfg``:
the 384 x 12 student and its decoder, the frozen tokenizer with the prompted
ViT-B teacher, 8192 codes, bf16 compute) in training mode on (8, 1024, 3)
zeros, its weights set as the JAX entry's ``materialize`` sets its
variables (``materialize``), and ``forward(model, pts)`` its loss under the
streams of ``rngs(1)``. The train-mode forward updates the BatchNorm running
statistics in place (JAX's returns them, and the entry drops them).

``dryrun_multichip(n)`` starts ``n`` ranks (gloo; on the card all of them
share card 0, NCCL taking one rank a card) and takes one train step of each
of the seven graphs of the JAX dry run at its tiny shapes, the global batch
B = 2n split over the ranks' data indices (``act_tpu_torch.parallel``):
the distillation step, tensor parallelism at data n/2 x model 2 (``n``
even) on the distillation step's weights, the Stage-I dVAE, the finetune
step with the sharded eval (each rank's logits of its rows, gathered,
against the forward of the whole batch), ``ACT_PointBERT`` with its queue
and EMA, and the semantic and part segmentation steps. Every rank reports
each leg's loss (the ranks' mean) and a digest of every tensor of the model
that is not a tensor-parallel shard; the digests must be equal on every
rank. Prints JAX's lines, ending in ``dryrun_multichip(n): mesh={...} all
graphs OK``, and returns each leg's record. The distillation leg's loss is
the one-process step's on the global batch (``distill_step``), but for the
Gumbel noise, which each data index draws from its own folded seed
(``ops.gumbel_argmax``).

  python -m act_tpu_torch.graft_entry [--ranks N] [--device cpu]

Runs on the card unless ``device="cpu"`` (``--device cpu``); without a card
it raises. Not ported: ``ACT_TPU_SCAN`` (the scanned stacks are a compile
trick) and the kernel mesh.
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import os
import socket
import subprocess
import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from act_tpu_torch import parallel
from act_tpu_torch.datasets.transforms import scale_and_translate
from act_tpu_torch.engine import builder, runner_pretrain
from act_tpu_torch.engine.serve import load_model
from act_tpu_torch.engine.train_state import (autoencoder_step, finetune_step, pretrain_step,
                                              seg_step, step_rngs)
from act_tpu_torch.models import MODELS
from act_tpu_torch.ops import resolve_device
from act_tpu_torch.parallel import tp
from act_tpu_torch.profiling import card_line
from act_tpu_torch.utils.config import ConfigDict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_POINTS = 128  # the dry run's clouds
RESULT = "rank-{}.pt"
EVAL_TOL = 2e-5  # the sharded eval against the whole batch's forward (rtol and atol)


def pretrain_cfg(tiny: bool = False) -> ConfigDict:
    """The flagship model's config (``__graft_entry__._pretrain_cfg``): the
    ``pretrain_act_distill.yaml`` widths, or the tiny ones of the dry run."""
    if tiny:
        dvae = dict(group_size=8, num_group=16, encoder_dims=32, num_tokens=64,
                    tokens_dims=32, decoder_dims=32, visual_embed_dim=48,
                    visual_embed_depth=2, visual_embed_heads=4,
                    num_prompt_token=4, use_deep_prompt=True,
                    visual_embed_pos="after_dgcnn1", freeze_visual_embed=True,
                    visual_embed_type="vit_tiny")
        tc = dict(mask_ratio=0.8, mask_type="rand", proj="linear", embed_dim=32,
                  encoder_dims=32, depth=2, drop_path_rate=0.1, cls_dim=32,
                  replace_pob=0.0, num_heads=4, decoder_depth=1,
                  decoder_num_heads=4, return_all_tokens=False, cls_loss=False,
                  register_shallow_hook=1)
    else:
        dvae = dict(group_size=32, num_group=64, encoder_dims=384,
                    num_tokens=8192, tokens_dims=384, decoder_dims=384,
                    visual_embed_dim=768, visual_embed_depth=12,
                    visual_embed_heads=12, num_prompt_token=64,
                    use_deep_prompt=True, visual_embed_pos="after_dgcnn1",
                    freeze_visual_embed=True,
                    visual_embed_type="vit_base_patch16_384", dtype="bf16")
        tc = dict(mask_ratio=0.8, mask_type="rand", proj="linear", embed_dim=384,
                  encoder_dims=384, depth=12, drop_path_rate=0.1, cls_dim=512,
                  replace_pob=0.0, num_heads=6, decoder_depth=2,
                  decoder_num_heads=6, return_all_tokens=False, cls_loss=False,
                  register_shallow_hook=9, dtype="bf16")
    return ConfigDict(dict(NAME="ACT_PointDistillation", loss="cosine",
                           transformer_config=tc, dvae_config=dvae))


def rngs(seed: int = 0, device="cuda") -> Dict[str, torch.Generator]:
    """The model's random streams from ``seed`` (``__graft_entry__._rngs``;
    the port's streams are generators on the device, ``step_rngs``)."""
    return step_rngs(seed, 0, resolve_device(device))


@torch.no_grad()
def materialize(model: nn.Module, seed: int = 0) -> nn.Module:
    """Every tensor of ``model`` set as the JAX entry sets its variables:
    integers zero; 1-D tensors one where JAX names them ``scale`` or ``var``
    (a norm's ``weight``, a BatchNorm's ``running_var``), else zero; the rest
    N(0, 0.02) from a generator seeded with ``seed`` on the model's device.
    Returns ``model``."""
    gen = None
    for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
        if not t.is_floating_point():
            t.zero_()
        elif t.dim() <= 1:
            t.fill_(1.0 if name.endswith((".weight", "running_var")) else 0.0)
        else:
            if gen is None:
                gen = torch.Generator(device=t.device).manual_seed(seed)
            t.normal_(0.0, 0.02, generator=gen)
    return model


def entry(device="cuda") -> Tuple[Callable, Tuple[nn.Module, torch.Tensor]]:
    """``(forward, (model, pts))``: the flagship forward (the module's note)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MODELS.build(pretrain_cfg(tiny=False))
    model = materialize(model.to_empty(device=dev)).train()
    pts = torch.zeros(8, 1024, 3, device=dev)

    def forward(model: nn.Module, pts: torch.Tensor) -> torch.Tensor:
        return model(pts, rngs=rngs(1, pts.device))
    return forward, (model, pts)


# ---------------------------------------------------------------------------
# the dry run's legs, in each rank
# ---------------------------------------------------------------------------

def train_cfg(model_cfg) -> ConfigDict:
    """The dry run's optimizer (``__graft_entry__._train_cfg``) around ``model_cfg``."""
    return ConfigDict(dict(
        optimizer=dict(type="AdamW", kwargs=dict(lr=1e-3, weight_decay=0.05)),
        scheduler=dict(type="CosLR", kwargs=dict(epochs=3, initial_epochs=1)),
        grad_norm_clip=10, step_per_update=1, model=dict(model_cfg)))


def tiny_dvae_cfg() -> ConfigDict:
    return ConfigDict(dict(
        NAME="DiscreteVAE", group_size=8, num_group=16, encoder_dims=32,
        num_tokens=64, tokens_dims=32, decoder_dims=32,
        visual_embed_type="vit_tiny", visual_embed_dim=48,
        visual_embed_depth=2, visual_embed_heads=4,
        visual_embed_pos="after_dgcnn1", freeze_visual_embed=True,
        num_prompt_token=4, use_deep_prompt=True))


def global_batch(seed: int, B: int) -> np.ndarray:
    """The leg's (B, N_POINTS, 3) clouds, from ``seed`` as JAX draws them."""
    return np.random.default_rng(seed).normal(size=(B, N_POINTS, 3)).astype(np.float32)


def rows(x, dev) -> torch.Tensor:
    """This rank's rows of the global ``x`` (its data index's share)."""
    b = len(x) // parallel.data_count()
    d = parallel.data_index()
    return torch.as_tensor(np.asarray(x[d * b:(d + 1) * b])).to(dev)


def digests(model: nn.Module) -> Dict[str, str]:
    """A digest of the bytes of each tensor of ``model``'s state dict that is
    not a tensor-parallel shard."""
    out = {}
    for k, t in model.state_dict().items():
        if tp.tp_split(k) is None or not tp.is_sharded(model):
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
            out[k] = hashlib.sha1(raw.tobytes()).hexdigest()
    return out


def mesh_shape() -> Dict[str, int]:
    return {"data": parallel.data_count(), "model": parallel.model_count()}


def record(loss: float, model: nn.Module, note: str = "") -> Dict:
    return {"loss": parallel.reduce_mean_scalar(float(loss)), "digests": digests(model),
            "mesh": mesh_shape(), "note": note}


def distill_step(pts: np.ndarray, dev, state_dict=None) -> Tuple[float, nn.Module]:
    """The distillation leg: the tiny ``ACT_PointDistillation`` (seed 0, or
    ``state_dict``), its tokenizer frozen and cast as the trainer does,
    sharded under a tensor-parallel grid, one step on this rank's rows of
    ``pts`` (step 0, the streams of seed 7). Returns (this rank's loss, the
    model)."""
    cfg = train_cfg(pretrain_cfg(tiny=True))
    model = runner_pretrain.build_pretrain_model(cfg.model, 0, state_dict)
    model = tp.shard_module(runner_pretrain.freeze_tokenizer(model, cfg).to(dev))
    parallel.broadcast_module(model)
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    loss = pretrain_step(model, opt, schedule, rows(pts, dev), 0, step_rngs(7, 0, dev),
                         scale_and_translate, cfg.grad_norm_clip)
    return float(loss), model


def leg_tp(dev, B: int, state_dict) -> Dict:
    """Data n/2 x model 2 on the distillation leg's weights: the MLP and
    attention weights sharded after the step, the other tensors equal."""
    parallel.initialize_model_parallel(2)
    try:
        loss, model = distill_step(global_batch(1, B), dev, state_dict)
        blk = model.ACT_encoder.blocks.blocks[0]
        full = int(pretrain_cfg(tiny=True).transformer_config.embed_dim)
        got = {"mlp fc1": blk.mlp.fc1.weight.shape[0] * 2 == 4 * full,
               "mlp fc2": blk.mlp.fc2.weight.shape[1] * 2 == 4 * full,
               "attn qkv": blk.attn.qkv.weight.shape[0] * 2 == 3 * full,
               "attn proj": blk.attn.proj.weight.shape[1] * 2 == full}
        if not all(got.values()):
            raise RuntimeError(f"dryrun tp: shardings {got}")
        return record(loss, model, f"shardings {list(got)}")
    finally:
        parallel.initialize_model_parallel(1)


def leg_dvae(dev, B: int) -> Dict:
    cfg = train_cfg(tiny_dvae_cfg())
    model = load_model(cfg, None, 0, dev)
    parallel.broadcast_module(model)
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    loss = autoencoder_step(model, opt, schedule, rows(global_batch(2, B), dev), 0,
                            step_rngs(9, 0, dev), 1.0, 0.0, cfg.grad_norm_clip)[0]
    return record(loss, model)


def leg_finetune(dev, B: int) -> Dict:
    """The finetune step, then the sharded eval: each rank's logits of its
    rows, gathered in data-index order, against the eval forward of the
    whole batch (within ``EVAL_TOL``)."""
    cfg = train_cfg(dict(NAME="PointTransformer", embed_dim=32, depth=2, drop_path_rate=0.1,
                         cls_dim=8, num_heads=4, group_size=8, num_group=16,
                         encoder_dims=32))
    model = load_model(cfg, None, 0, dev)
    parallel.broadcast_module(model)
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(B, N_POINTS, 3)).astype(np.float32)
    labels = rng.integers(0, 8, size=(B,))
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    loss = finetune_step(model, opt, schedule, rows(pts, dev), rows(labels, dev), 0,
                         step_rngs(10, 0, dev), None, cfg.grad_norm_clip)[0]
    model.eval()
    with torch.no_grad():
        sharded = parallel.all_gather_cat(model(rows(pts, dev)))
        whole = model(torch.from_numpy(pts).to(dev))
    diff = float((sharded - whole).abs().max())
    if not torch.allclose(sharded, whole, rtol=EVAL_TOL, atol=EVAL_TOL):
        raise RuntimeError(f"dryrun finetune: sharded eval differs by {diff}")
    return record(loss, model, f"sharded-eval parity OK (max |diff| {diff:.3g})")


def leg_pointbert(dev, B: int) -> Dict:
    """ACT_PointBERT with a queue of 2B keys: the pointer advanced by the
    global batch, the queue written, the k encoder moved by the EMA."""
    model_cfg = pretrain_cfg(tiny=True)
    model_cfg.NAME = "ACT_PointBERT"
    model_cfg.m, model_cfg.T, model_cfg.K = 0.999, 0.07, 2 * B
    model_cfg.transformer_config.update(mask_ratio=[0.25, 0.45], moco_loss=False,
                                        dvae_loss=True, cutmix_loss=True)
    cfg = train_cfg(model_cfg)
    model = runner_pretrain.freeze_tokenizer(
        runner_pretrain.build_pretrain_model(cfg.model, 0), cfg).to(dev)
    parallel.broadcast_module(model)
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    k_before = [p.detach().clone() for p in model.transformer_k.parameters()]
    queue_before = model.queue.detach().clone()
    loss = pretrain_step(model, opt, schedule, rows(global_batch(4, B), dev), 0,
                         step_rngs(11, 0, dev), scale_and_translate, cfg.grad_norm_clip,
                         float(model_cfg.m))
    ptr = int(model.queue_ptr)
    moved = sum(float((a - b).abs().sum())
                for a, b in zip(k_before, model.transformer_k.parameters()))
    if ptr != B % (2 * B) or torch.equal(queue_before, model.queue) or not moved > 0:
        raise RuntimeError(f"dryrun pointbert: queue_ptr {ptr}, queue written "
                           f"{not torch.equal(queue_before, model.queue)}, k moved {moved}")
    return record(loss, model, f"queue_ptr={ptr} ema-moved OK")


def leg_seg(dev, B: int, part: bool) -> Dict:
    """A segmentation step at the CLI's compute policy (bf16), 16 groups of 8,
    AdamW at optax's defaults (lr 1e-3, decay 1e-4), no clip."""
    cls_dim = 50 if part else 13
    cfg = dict(NAME="PartSegTransformer" if part else "SemSegTransformer", cls_dim=cls_dim,
               num_group=16, group_size=8, dtype="bf16")
    model = load_model({"model": cfg}, None, 0, dev)
    parallel.broadcast_module(model)
    rng = np.random.default_rng(6 if part else 5)
    pts = rng.normal(size=(B, N_POINTS, 3)).astype(np.float32)
    one_hot = (rows(np.eye(16, dtype=np.float32)[rng.integers(0, 16, size=(B,))], dev)
               if part else None)
    seg = rng.integers(0, cls_dim, size=(B, N_POINTS))
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=1e-3,
                            weight_decay=1e-4)
    loss = seg_step(model, opt, lambda step: 1e-3, rows(pts, dev), rows(seg, dev), 0,
                    step_rngs(13 if part else 12, 0, dev), one_hot, None, None)
    return record(loss, model)


def run_rank(out_dir: str, device: str) -> None:
    """One rank of ``dryrun_multichip``, started with torchrun's variables:
    the seven legs, its records to ``out_dir/rank-<rank>.pt``."""
    dev = resolve_device(device)
    parallel.initialize_distributed(device, backend="gloo")
    if not parallel.is_distributed():
        raise RuntimeError("dryrun rank: no process group (RANK and WORLD_SIZE unset)")
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // parallel.process_count()))
    dev = parallel.local_device(device)
    n = parallel.process_count()
    B = 2 * n
    out = {}
    loss, model = distill_step(global_batch(0, B), dev)
    out["distill"] = record(loss, model)
    if n >= 2 and n % 2 == 0:
        out["tp"] = leg_tp(dev, B, {k: v.cpu() for k, v in model.state_dict().items()})
    del model
    out["dvae"] = leg_dvae(dev, B)
    out["finetune"] = leg_finetune(dev, B)
    out["pointbert"] = leg_pointbert(dev, B)
    out["semseg"] = leg_seg(dev, B, part=False)
    out["partseg"] = leg_seg(dev, B, part=True)
    from act_tpu_torch.ops import _backend
    torch.save({"legs": out, "launches": dict(_backend.LAUNCHES)},
               os.path.join(out_dir, RESULT.format(parallel.process_index())))
    parallel.destroy_distributed()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 900) -> Dict:
    """The dry run over ``n_devices`` ranks (the module's note); returns
    ``legs``, each leg's record (rank 0's, with every rank's loss under
    ``losses``), and ``launches``, each rank's kernel launches. Raises if a
    rank fails or a leg's replicated tensors differ between ranks."""
    import tempfile

    from act_tpu_torch.ops import _backend
    dev = resolve_device(device)
    if dev.type == "cuda":
        _backend.build_kernels()  # once, before the ranks load them
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(n_devices), "LOCAL_RANK": "0"}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    with tempfile.TemporaryDirectory(prefix="act_tpu_torch_dryrun_") as tmp:
        procs = [subprocess.Popen([sys.executable, "-m", "act_tpu_torch.graft_entry",
                                   "--rank-of", tmp, "--device", str(dev.type)],
                                  cwd=ROOT, env={**env, "RANK": str(r)})
                 for r in range(n_devices)]
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank exit codes {rcs}")
        ranks = [torch.load(os.path.join(tmp, RESULT.format(r)), weights_only=False)
                 for r in range(n_devices)]
    where = "cpu" if dev.type == "cpu" else card_line()
    print(f"dryrun_multichip({n_devices}): {n_devices} gloo ranks on {dev.type} ({where})",
          flush=True)
    out = {}
    for leg, rec in ranks[0]["legs"].items():
        differ = sorted(k for r in ranks[1:] for k, d in r["legs"][leg]["digests"].items()
                        if rec["digests"][k] != d)
        if differ:
            raise RuntimeError(f"dryrun {leg}: tensors differ between ranks: {differ}")
        out[leg] = {**rec, "losses": [r["legs"][leg]["loss"] for r in ranks]}
        print(f"dryrun {leg} mesh={rec['mesh']} loss={rec['loss']:.4f} "
              f"{rec['note'] + ' ' if rec['note'] else ''}"
              f"({len(rec['digests'])} tensors bit-equal on every rank) OK", flush=True)
    print(f"dryrun_multichip({n_devices}): mesh={out['distill']['mesh']} "
          f"all graphs OK", flush=True)
    return {"legs": out, "launches": [r["launches"] for r in ranks]}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: the cards, 1 on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank-of", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of:
        run_rank(args.rank_of, args.device)
        return
    n = args.ranks or (torch.cuda.device_count() if resolve_device(args.device).type == "cuda"
                       else 1)
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
