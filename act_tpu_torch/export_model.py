"""Export a serving forward to a self-contained artifact, or run one.

Counterpart of ``tools/export_model.py``. ``export`` traces one of the five
eval forwards (``engine/export.py``) with the weights baked in and writes
``DST`` (a ``.pt2`` from ``torch.export.save``) and ``DST.json`` (its
sidecar); ``run`` loads an artifact with no model code and runs a batch of
random clouds through it.

  python -m act_tpu_torch.export_model export \\
      --config cfgs/finetune_classification/full/finetune_modelnet.yaml \\
      [--kind classifier|features|tokenize|dvae] [--ckpts model.pth] \\
      [--batch N|sym] [--n_in N] [--no_fps] --dst model.pt2
  python -m act_tpu_torch.export_model export --kind segmentation \\
      --seg_task partseg|semseg [--npoint 2048] [--num_group 128] [--dtype bf16|f32] \\
      --dst seg.pt2
  python -m act_tpu_torch.export_model run --src model.pt2 [--batch 2]

Both run on the card unless ``--device cpu`` is given. On the card the FPS,
k-smallest and gather kernels stay in the artifact as ``act_tpu_torch::*``
ops; on the CPU it holds their plain versions. The ``dvae`` kind needs a fixed
``--batch`` (its Gumbel draw is baked for that batch).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

KINDS = ("classifier", "features", "tokenize", "dvae", "segmentation")


def cmd_export(args) -> None:
    from act_tpu_torch.engine import export as ex
    from act_tpu_torch.ops import resolve_device

    resolve_device(args.device)
    batch = None if args.batch in (None, "sym") else int(args.batch)
    common = dict(ckpt_path=args.ckpts, batch=batch, seed=args.seed, device=args.device)
    if args.kind == "segmentation":
        exported = ex.export_segmentation(args.seg_task, npoint=args.npoint,
                                          num_group=args.num_group, dtype=args.dtype, **common)
    elif not args.config:
        raise SystemExit(f"--config is required for --kind {args.kind}")
    elif args.kind == "classifier":
        exported = ex.export_classifier(args.config, n_in=args.n_in, with_fps=not args.no_fps,
                                        **common)
    elif args.kind == "features":
        exported = ex.export_features(args.config, n_in=args.n_in, **common)
    else:
        fn = ex.export_dvae_tokenize if args.kind == "tokenize" else ex.export_dvae_recon
        exported = fn(args.config, **common)
    side = ex.save_exported(exported, args.dst)
    print(f"wrote {args.dst} ({side['bytes'] / 2**20:.1f} MiB) and {args.dst}.json; inputs "
          f"{side['in_shapes']} -> output {side['out_shape']} on {side['device']}"
          f"{' with the kernel ops' if side['needs_ops'] else ''}")


def cmd_run(args) -> None:
    from act_tpu_torch.engine.export import load_exported

    fn = load_exported(args.src, device=args.device)
    meta = fn.meta
    b = args.batch
    batch_dim = meta["in_shapes"][0][0]
    if isinstance(batch_dim, int) and b != batch_dim:
        print(f"the artifact has a fixed batch of {batch_dim}; running that")
        b = batch_dim
    pts = np.random.default_rng(0).normal(size=(b, int(meta["n_in"]), 3))
    pts = (pts / np.abs(pts).max()).astype(np.float32)
    extra = ()
    if len(meta["in_shapes"]) > 1:  # partseg: the object-category one-hot
        n_cat = int(meta["in_shapes"][1][-1])
        extra = (np.eye(n_cat, dtype=np.float32)[np.arange(b) % n_cat],)
    t0 = time.perf_counter()
    out = fn(pts, *extra)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    dt = time.perf_counter() - t0
    kind = meta.get("kind")
    out = out.cpu()
    name = {"classifier": "logits", "features": "features", "tokenize": "tokens",
            "dvae": "recon", "segmentation": "log_probs"}.get(kind, "output")
    extra_info = (f"argmax {out.argmax(-1).tolist()}" if kind == "classifier" else
                  f"range [{int(out.min())}, {int(out.max())}]" if kind == "tokenize" else
                  f"finite={bool(torch.isfinite(out).all())}")
    print(f"{name} {tuple(out.shape)}  {extra_info}  ({dt * 1e3:.1f} ms, first call)")


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("export")
    e.add_argument("--config", default=None,
                   help="YAML of the model (every kind but segmentation)")
    e.add_argument("--kind", default="classifier", choices=KINDS)
    e.add_argument("--seg_task", default="semseg", choices=["partseg", "semseg"])
    e.add_argument("--npoint", type=int, default=2048, help="points a segmentation cloud")
    e.add_argument("--num_group", type=int, default=128, help="segmentation groups")
    e.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                   help="segmentation compute dtype")
    e.add_argument("--ckpts", default=None, help="reference .pth (else seeded weights)")
    e.add_argument("--dst", required=True, help="the artifact (.pt2); the sidecar is DST.json")
    e.add_argument("--batch", default="sym", help="'sym' (a symbolic batch) or a fixed int")
    e.add_argument("--n_in", type=int, default=None, help="input points (default npoints)")
    e.add_argument("--no_fps", action="store_true", help="classifier: no FPS resample")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    e.set_defaults(fn=cmd_export)
    r = sub.add_parser("run")
    r.add_argument("--src", required=True)
    r.add_argument("--batch", type=int, default=2)
    r.add_argument("--device", default="cuda", help="the device the artifact was exported on")
    r.set_defaults(fn=cmd_run)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
