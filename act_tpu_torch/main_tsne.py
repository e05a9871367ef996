"""The t-SNE CLI (counterpart of the root ``main_tsne.py``).

  python -m act_tpu_torch.main_tsne --config cfgs/tsne/tsne_scan_hardest.yaml \\
      [--ckpts <finetuned .pth>] [--exp_name NAME] [--max_batches N] [--device cpu]

The flags and experiment directory of the port's other CLIs
(``act_tpu_torch/utils/parser.py``). The pretrained and finetuned
checkpoints are ``ckpt_pretrained`` and ``ckpt_finetuned`` in the YAML, or
``--ckpts`` for the finetuned one, read as ``.pth`` (an orbax name raises:
convert a JAX package's orbax checkpoint first, where JAX is installed, with
``python tools/convert_checkpoint_to_torch.py --config <yaml> --src <orbax dir>
--dst <.pth> --weights_only``);
without them both models keep the weights drawn from ``--seed``.
``--max_batches N`` keeps the first N test batches and 2 vote rounds (the JAX
CLI's ``--smoke`` keeps 2). The embeddings go to ``tsne_pretrained.npz`` and
``tsne_finetuned.npz`` in the experiment directory. The run is on the card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from act_tpu_torch.main import setup
from act_tpu_torch.ops import resolve_device


def main(argv: Optional[List[str]] = None) -> None:
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--max_batches", type=int, default=None,
                       help="keep the first N test batches and 2 vote rounds")
    extra.add_argument("--device", default="cuda")
    known, rest = extra.parse_known_args(argv)
    resolve_device(known.device)  # no card: raise before making directories and logs
    args, config, logger = setup(rest + ["--device", known.device])
    from act_tpu_torch.engine import runner_tsne

    runner_tsne.tsne_net(args, config, max_batches=known.max_batches)


if __name__ == "__main__":
    main()
