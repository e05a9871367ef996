"""The port's preemption guard and mid-epoch resume, case for case as
``tests/test_preemption.py`` pins the JAX package's:

- SIGTERM sets the guard's flag (no exception) and ``uninstall`` restores the
  handler before it; ``at_step`` sets it after that many steps;
- ``set_epoch(e, start_batch=k)`` gives exactly the batches of an
  uninterrupted iteration from batch k (in process and with 2 forked
  workers), and the next epoch starts at 0;
- a preemption save carries the cursor ``{epoch, next_batch}`` and
  ``resume_state`` re-enters that epoch at that batch; an epoch-end save
  carries none and resumes at the next epoch;
- a small finetune and a small Stage-I ``run_net``, preempted after a step and
  resumed, end bit-equal to the uninterrupted run (weights, statistics,
  optimizer state; the anneals too): a step's draws are a function of (seed,
  step), the loader's order of (seed, epoch), and the datasets' own item
  draws (ModelNet's row shuffle, ShapeNet's subsample: one stream over the
  items a process fetches) are saved with the cursor and put back;
- over 2 ranks (spawned, gloo) the flag set on one rank stops both at the
  same step, in a bare loop and in a small finetune ``run_net``, whose
  resume (each rank its own draw states) ends bit-equal to the
  uninterrupted 2-rank run: ``test_two_ranks_stop_at_the_same_step`` in
  ``tests/test_torch_port_dist.py``, on that module's spawned ranks.

Every check is exact.
"""
import os
import signal

import numpy as np
import pytest
import torch

from act_tpu_torch.datasets.loader import DataLoader
from act_tpu_torch.engine import checkpoint as ckpt_lib
from act_tpu_torch.engine import runner_autoencoder, runner_finetune
from act_tpu_torch.engine.preemption import GUARD, PreemptionGuard

from tests.test_torch_port_finetune_data import small_run_cfg
from tests.test_torch_port_stage1_run import run_cfg, tree  # noqa: F401 (a fixture)

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)


class Clouds:
    """A small deterministic (taxonomy, id, (points, label)) dataset."""

    def __init__(self, n=24, npts=32):
        rng = np.random.default_rng(7)
        self.x = rng.normal(size=(n, npts, 3)).astype(np.float32)
        self.y = (np.arange(n) % 4).astype(np.int32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return "syn", str(i), (self.x[i], self.y[i])


@pytest.fixture
def guard():
    """The process-wide guard, clear before and after."""
    GUARD.reset()
    yield GUARD
    GUARD.reset()
    GUARD.at_step = None


# ---------------------------------------------------------------------------
# the guard and the loader's cursor
# ---------------------------------------------------------------------------

def test_sigterm_sets_flag_and_uninstall_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    g = PreemptionGuard().install()
    try:
        assert not g.requested and not g.check(5)
        os.kill(os.getpid(), signal.SIGTERM)  # delivered to the main thread at once
        assert g.requested and g.check()
    finally:
        g.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before


def test_at_step_hook():
    g = PreemptionGuard(at_step=3)
    assert not g.check(2)
    assert g.check(3) and g.requested
    g.reset()
    assert not g.requested


@pytest.mark.parametrize("num_workers", [0, 2])
def test_start_batch_is_the_tail_of_a_full_iteration(num_workers):
    full = DataLoader(Clouds(), 4, shuffle=True, seed=11, prefetch=0, num_workers=num_workers)
    part = DataLoader(Clouds(), 4, shuffle=True, seed=11, prefetch=0, num_workers=num_workers)
    try:
        full.set_epoch(2)
        part.set_epoch(2, start_batch=3)
        ref, got = list(full), list(part)
        assert len(got) == len(ref) - 3 and len(part) == len(full)
        for (_, _, (xa, ya)), (_, _, (xb, yb)) in zip(ref[3:], got):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    finally:
        full.close()
        part.close()


def test_next_epoch_resets_the_cursor():
    ld = DataLoader(Clouds(), 4, shuffle=True, seed=11, prefetch=0)
    ld.set_epoch(0, start_batch=5)
    assert len(list(ld)) == len(ld) - 5
    ld.set_epoch(1)
    assert len(list(ld)) == len(ld)


def test_preemption_save_carries_the_cursor_and_an_epoch_end_save_does_not(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters())
    ckpt_lib.save_checkpoint(model, opt, 7, 1, None, {"acc": 2.0}, "ckpt-last", str(tmp_path),
                             data_iter={"epoch": 1, "next_batch": 3})
    payload = torch.load(tmp_path / "ckpt-last.pth", weights_only=True)
    assert payload["data_iter"] == {"epoch": 1, "next_batch": 3}
    assert ckpt_lib.resume_state(model, opt, str(tmp_path)) == (1, 7, {"acc": 2.0}, 3)
    ckpt_lib.save_checkpoint(model, opt, 9, 1, None, None, "ckpt-last", str(tmp_path))
    assert "data_iter" not in torch.load(tmp_path / "ckpt-last.pth", weights_only=True)
    assert ckpt_lib.resume_state(model, opt, str(tmp_path)) == (2, 9, {}, 0)


# ---------------------------------------------------------------------------
# run_net preempted and resumed
# ---------------------------------------------------------------------------

def assert_same_state(a_model, a_opt, b_model, b_opt):
    for k, x in a_model.state_dict().items():
        assert torch.equal(b_model.state_dict()[k], x), k
    a, b = a_opt.state_dict(), b_opt.state_dict()
    assert [g["lr"] for g in a["param_groups"]] == [g["lr"] for g in b["param_groups"]]
    for i, s in a["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(b["state"][i][name], s[name]), (i, name)


def test_finetune_run_net_preempted_and_resumed_is_bit_exact(tmp_path, guard, capsys):
    """3 steps of epoch 0 and its validation, against a run preempted after
    step 1 (ckpt-last with the cursor, no validation) and resumed for the
    epoch's other 2 steps (``max_steps`` caps the batches a run takes)."""
    cfg = small_run_cfg(bs=8)
    whole = runner_finetune.run_net(cfg, device="cpu", epochs=1, max_steps=3,
                                    experiment_path=str(tmp_path / "a"))
    guard.at_step = 1
    cut = runner_finetune.run_net(cfg, device="cpu", epochs=1, max_steps=3,
                                  experiment_path=str(tmp_path / "b"))
    assert cut.preempted and cut.steps == 1 and cut.epoch_loss == []
    assert "[PREEMPT] saved mid-epoch checkpoint at epoch 0 batch 1" in capsys.readouterr().out
    last = torch.load(tmp_path / "b" / "ckpt-last.pth", weights_only=True)
    assert last["data_iter"] == {"epoch": 0, "next_batch": 1} and last["step"] == 1
    assert [set(d) for d in last["dataset_rng"]] == [{"train", "val"}]  # a rank's ModelNet draws
    guard.reset()
    guard.at_step = None
    rest = runner_finetune.run_net(cfg, device="cpu", epochs=1, max_steps=2, resume=True,
                                   experiment_path=str(tmp_path / "b"))
    assert "resumed mid-epoch 0 at batch 1" in capsys.readouterr().out
    assert not rest.preempted and rest.steps == whole.steps == 3
    assert rest.best_metrics.state_dict() == whole.best_metrics.state_dict()
    assert_same_state(whole.state.model, whole.state.optimizer, rest.state.model,
                      rest.state.optimizer)
    assert "data_iter" not in torch.load(tmp_path / "b" / "ckpt-last.pth", weights_only=True)


def test_stage1_run_net_preempted_and_resumed_is_bit_exact(tmp_path, tree, guard):
    """Two epochs of 2 steps, against a run preempted after step 1 and
    resumed: the same weights, optimizer state, anneal iterations,
    temperatures, KLD weights and best metrics."""
    cfg = run_cfg(*tree)
    whole = runner_autoencoder.run_net(cfg, device="cpu", epochs=2,
                                       experiment_path=str(tmp_path / "a"))
    guard.at_step = 1
    cut = runner_autoencoder.run_net(cfg, device="cpu", epochs=2,
                                     experiment_path=str(tmp_path / "b"))
    assert cut.preempted and (cut.step, cut.n_itr) == (1, 1) and cut.best_metrics is None
    guard.reset()
    guard.at_step = None
    rest = runner_autoencoder.run_net(cfg, device="cpu", epochs=2, resume=True,
                                      experiment_path=str(tmp_path / "b"))
    assert (whole.step, whole.n_itr) == (rest.step, rest.n_itr) == (4, 4)
    assert cut.temps + rest.temps == whole.temps and len(set(whole.temps)) == 4
    assert cut.kld_weights + rest.kld_weights == whole.kld_weights
    assert rest.best_metrics.state_dict() == whole.best_metrics.state_dict()
    assert_same_state(whole.model, whole.optimizer, rest.model, rest.optimizer)
