"""The port's Stage-I CLI (counterpart of ``main_autoencoder.py:11-39``).

  python -m act_tpu_torch.main_autoencoder \
      --config cfgs/autoencoder/act_dvae_with_pretrained_transformer.yaml
  python -m act_tpu_torch.main_autoencoder --config <yaml> --val --ckpts <ckpt-best.pth>
  python -m act_tpu_torch.main_autoencoder --config <yaml> --test --ckpts <ckpt-best.pth>

Trains the dVAE (``engine/runner_autoencoder.run_net``, ``--resume`` from
the experiment directory's ckpt-last), or evaluates ``--ckpts`` on the val
split (``--val``) or on the test split with the reconstruction dump
(``--test``). The flags and the experiment directory are those of
``act_tpu_torch/utils/parser.py``. The run is on the card unless
``--device cpu`` is given. On N cards and under SIGTERM it behaves as
``act_tpu_torch/main.py`` says (``torch.distributed.run``, ``[PREEMPT]``,
``--resume``, ``--val_freq``, the writers).
"""
from __future__ import annotations

from typing import List, Optional

from act_tpu_torch.engine import runner_autoencoder
from act_tpu_torch.main import setup, writers
from act_tpu_torch.parallel import destroy_distributed


def main(argv: Optional[List[str]] = None) -> None:
    args, config, logger = setup(argv)
    train_writer, val_writer = writers(args)
    try:
        run(args, config, logger, train_writer)
    finally:
        train_writer.close()
        val_writer.close()
        destroy_distributed()


def run(args, config, logger, train_writer=None) -> None:
    if args.test:
        runner_autoencoder.test_net(config, ckpts=args.ckpts, seed=args.seed,
                                    device=args.device, experiment_path=args.experiment_path,
                                    logger=logger)
    elif args.val:
        runner_autoencoder.validate_net(config, ckpts=args.ckpts, seed=args.seed,
                                        device=args.device, logger=logger)
    else:
        runner_autoencoder.run_net(config, seed=args.seed, device=args.device,
                                   resume=args.resume, experiment_path=args.experiment_path,
                                   num_workers=args.num_workers, val_freq=args.val_freq,
                                   train_writer=train_writer, logger=logger)


if __name__ == "__main__":
    main()
