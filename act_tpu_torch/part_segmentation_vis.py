"""Part-segmentation dumps: per-shape ``.txt`` files of points, labels and predictions.

Counterpart of ``part_segmentation/main_vis.py:15-87`` (reference
part_segmentation/main_vis.py):

  python -m act_tpu_torch.part_segmentation_vis --ckpts part_seg.pth \\
      [--npoint 2048] [--num_group 128] [--root <ShapeNetPart dir>] \\
      [--out ./work_dirs/part_seg/vis] [--num_shapes 8] [--device cpu]

The model runs in f32, as the JAX tool's does, from ``--ckpts`` (a ``.pth``:
the port's ckpt-best or a reference file with either head-key layout),
else from the seed. For each of the first ``--num_shapes`` test shapes it
writes ``{category}_{i:03d}.txt`` (x, y, z, label, prediction; ``%.6f``),
the prediction the argmax over the shape's category's parts, and prints the
shape's point accuracy. It writes no ``.jpg``: the JAX tool renders one only
where matplotlib imports, and the card's machine has none. The JAX CLI's
``--smoke`` is not ported. The data fall back to synthetic shapes when the
root is absent; the run is on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from act_tpu_torch.datasets.segmentation_datasets import (NUM_SHAPE_CATEGORIES, SEG_CLASSES,
                                                          PartNormalDataset)
from act_tpu_torch.engine.serve import load_seg_model


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("part segmentation visualization")
    p.add_argument("--npoint", type=int, default=2048)
    p.add_argument("--num_group", type=int, default=128)
    p.add_argument("--ckpts", type=str, default=None, help="a part-seg .pth")
    p.add_argument("--root", type=str,
                   default="data/shapenetcore_partanno_segmentation_benchmark_v0_normal")
    p.add_argument("--out", type=str, default="./work_dirs/part_seg/vis")
    p.add_argument("--num_shapes", type=int, default=8)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def dump_shapes(model: torch.nn.Module, ds, out: str, num_shapes: int) -> List[str]:
    """The dumps of the first ``num_shapes`` shapes of ``ds`` by ``model``
    (eval mode, on its device) into ``out``; returns the files written."""
    dev = next(model.parameters()).device
    os.makedirs(out, exist_ok=True)
    cats, files = sorted(SEG_CLASSES), []
    for i in range(min(num_shapes, len(ds))):
        pts, cls, seg = ds[i]
        one_hot = np.eye(NUM_SHAPE_CATEGORIES, dtype=np.float32)[cls]
        with torch.inference_mode():
            logits = model(torch.from_numpy(pts[None, :, :3]).to(dev),
                           torch.from_numpy(one_hot[None]).to(dev))[0].float().cpu().numpy()
        cat = cats[cls]
        part_range = SEG_CLASSES[cat]
        pred = np.asarray(part_range)[logits[:, part_range].argmax(-1)]
        path = os.path.join(out, f"{cat}_{i:03d}.txt")
        np.savetxt(path, np.concatenate([pts[:, :3], seg[:, None], pred[:, None]], axis=1),
                   fmt="%.6f")
        files.append(path)
        print(f"{cat}_{i:03d}: acc={float((pred == seg).mean()):.3f} saved", flush=True)
    return files


def main(argv: Optional[List[str]] = None) -> List[str]:
    args = parse_args(argv)
    model = load_seg_model("partseg", args.ckpts, args.num_group, "f32", device=args.device)
    ds = PartNormalDataset(args.root, args.npoint, split="test")
    print("[VIS] the .txt dumps only: no rendered .jpg (no matplotlib on the card's machine)",
          flush=True)
    return dump_shapes(model, ds, args.out, args.num_shapes)


if __name__ == "__main__":
    main()
