"""The last helpers of ``act_tpu/utils/misc.py`` in the port
(``act_tpu_torch/utils/misc.py``) held against JAX's on the CPU.

Each random helper's core is given JAX's own draw (the permutation, the
dropped-group count, the direction) and must give JAX's clouds bit for bit;
the wrappers draw from a ``torch.Generator`` and keep the shapes.
``summary_parameters`` counts the port model's parameters as JAX's counts
the flax params of the same model (the folded conv biases left out), its
frozen teacher blocks as frozen.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from act_tpu.engine import builder as jbuilder
from act_tpu.utils import misc as jmisc

from act_tpu_torch.engine import runner_autoencoder
from act_tpu_torch.utils import misc

from tests.test_torch_port_stage1 import FROZEN, VIT_CFG, build, jax_model, smoke_cfg

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)


def clouds(seed, B=3, N=256):
    return np.random.default_rng(seed).normal(size=(B, N, 3)).astype(np.float32)


def test_worker_seed_fn_matches_jax():
    for w, base in ((0, 0), (3, 17), (7, 2 ** 31)):
        assert (misc.worker_seed_fn(w, base).integers(0, 2 ** 31, 5).tolist()
                == jmisc.worker_seed_fn(w, base).integers(0, 2 ** 31, 5).tolist())


def test_random_subsample_core_matches_jax():
    """JAX's per-cloud permutations gathered by the port: JAX's clouds."""
    pts = clouds(0)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jmisc.random_subsample(key, jnp.asarray(pts), 100))
    perms = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 256)[:100])(
        jax.random.split(key, 3)))
    got = misc.take_points(torch.from_numpy(pts), torch.from_numpy(perms.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = misc.random_subsample(torch.from_numpy(pts), 100, torch.Generator().manual_seed(1))
    assert drawn.shape == (3, 100, 3)
    for b in range(3):  # distinct points of the cloud
        rows = {tuple(r) for r in drawn[b].tolist()}
        assert len(rows) == 100 and rows <= {tuple(r) for r in pts[b].tolist()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_dropping_core_matches_jax(seed):
    """``drop_groups`` at the count JAX's key draws: JAX's clouds bit for bit
    (FPS, kNN and the gathers at G=16, M=32 on 256-point clouds)."""
    pts = clouds(10 + seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jmisc.random_dropping(key, jnp.asarray(pts), group_size=32,
                                            max_drop_groups=12, num_group=16))
    num_drop = int(jax.random.randint(jax.random.split(key)[0], (), 0, 13))
    got = misc.drop_groups(torch.from_numpy(pts), num_drop, group_size=32, num_group=16)
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = misc.random_dropping(torch.from_numpy(pts), torch.Generator().manual_seed(seed),
                                 group_size=32, max_drop_groups=12, num_group=16)
    assert drawn.shape == pts.shape and torch.isfinite(drawn).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_separate_point_cloud_core_matches_jax(seed):
    """``crop_by_direction`` with JAX's normal draw: both parts bit-equal."""
    pts = clouds(20 + seed, N=200)
    key = jax.random.PRNGKey(seed)
    want = [np.asarray(a) for a in jmisc.separate_point_cloud(key, jnp.asarray(pts), 200, 48)]
    direction = np.array(jax.random.normal(jax.random.split(key)[0], (3, 1, 3)))
    got = misc.crop_by_direction(torch.from_numpy(pts), torch.from_numpy(direction), 48)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    keep, cut = misc.separate_point_cloud(torch.from_numpy(pts), 200, 48,
                                          torch.Generator().manual_seed(seed))
    assert keep.shape == (3, 152, 3) and cut.shape == (3, 48, 3)


def test_summary_parameters_totals_match_jax(capsys):
    """The ViT dVAE at smoke width, its teacher's blocks and norm frozen
    (``runner_autoencoder.prepare_model``; JAX's mask from the same paths):
    the same total and trainable counts, and the same totals line."""
    cfg = smoke_cfg(VIT_CFG)
    rng = np.random.default_rng(0)
    jm, v = jax_model(cfg, rng, clouds(0, 2, 128))
    mask = jbuilder.freeze_mask_from_paths(v["params"], FROZEN)
    want = jmisc.summary_parameters(v["params"], mask)
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    model = runner_autoencoder.prepare_model(cfg, 0, "cpu")
    assert any(not p.requires_grad for p in model.parameters())
    got = misc.summary_parameters(model)
    out = capsys.readouterr().out.strip().splitlines()
    assert got == want and want[1] < want[0]
    assert out[-1] == want_line
    rows = [ln for ln in out if ln.startswith("  ")]
    assert len(rows) == len(jax.tree_util.tree_leaves(v["params"]))
    model = build(cfg, v)  # every parameter trainable
    assert misc.summary_parameters(model, logger="silent") == (want[0], want[0])
