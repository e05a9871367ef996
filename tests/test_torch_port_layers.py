"""The port's Stage-II modules held against the JAX package on the CPU.

Each module of the distillation path runs the same weights in both packages:
JAX parameters are drawn, perturbed away from their trivial init, and
carried to the port by the weight bridge; the student's mask is pinned to the
one the flax module drew. Inputs are numpy arrays from a seed. f32 compares
at atol 1e-5 (sum order only), indices exactly.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from act_tpu import ops as jops
from act_tpu.models import common as jcommon
from act_tpu.models.act import VisableOnlyMaskTransformer as JStudent
from act_tpu.models.teacher import PromptedTeacher as JTeacher

from act_tpu_torch import ops
from act_tpu_torch.engine import weights
from act_tpu_torch.models import PromptedTeacher, common
from act_tpu_torch.models.act import VisableOnlyMaskTransformer
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_stage2 import RNGS, close, jax_variables, japply, t, tiny_cfg

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)


def test_graph_feature_idx_matches_jax(rng):
    coor = rng.normal(size=(3, 40, 3)).astype(np.float32)
    want = np.asarray(jops.graph_feature_idx(jnp.asarray(coor), jnp.asarray(coor), k=4))
    for fn in (ops.graph_feature_idx, ops.graph_feature_idx_ref):
        got = fn(t(coor), t(coor), 4)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_dgcnn_matches_jax(rng):
    f = rng.normal(size=(2, 12, 16)).astype(np.float32)
    coor = rng.normal(size=(2, 12, 3)).astype(np.float32)
    jm = jcommon.DGCNN(24)
    v = jax_variables(jm, rng, f, coor)
    tm = common.DGCNN(16, 24)
    tm.load_state_dict(weights.dgcnn_state(v["params"], ""), strict=True)
    assert tm.layer1[0].weight.shape == (256, 256, 1, 1)
    close(tm(t(f), t(coor)), japply(jm, v, f, coor))


def test_prompted_teacher_matches_jax(rng):
    tok = rng.normal(size=(2, 16, 32)).astype(np.float32)
    center = rng.normal(size=(2, 16, 3)).astype(np.float32)
    jm = JTeacher(embed_dim=48, depth=2, num_heads=4, tokens_dims=32, num_prompt_token=4)
    v = jax_variables(jm, rng, tok, center)
    tm = PromptedTeacher(48, 2, 4, 32, 4, True).eval()
    tm.load_state_dict(weights.teacher_state(v["params"], ""), strict=True)
    close(tm(t(tok), t(center)), japply(jm, v, tok, center))


def test_transformer_decoder_matches_jax(rng):
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    pos = rng.normal(size=(2, 9, 24)).astype(np.float32)
    jm = jcommon.TransformerDecoder(24, 2, 3, scan=False)
    v = jax_variables(jm, rng, x, pos, return_token_num=5)
    tm = common.TransformerDecoder(24, 2, 3).eval()
    p = v["params"]
    tm.load_state_dict({**weights.blocks_state(p, "blocks"),
                        **weights.norm_state(p["norm"], "norm")}, strict=True)
    out = tm(t(x), t(pos), 5)
    assert out.shape == (2, 5, 24)
    close(out, japply(jm, v, x, pos, return_token_num=5))


def test_group_encoder_train_mode_matches_jax(rng):
    """Batch statistics normalize; the running ones update to 0.9 * old +
    0.1 * batch with the biased variance."""
    g = (0.3 * rng.normal(size=(2, 16, 8, 3))).astype(np.float32)
    jm = jcommon.GroupEncoder(48)
    v = jax_variables(jm, rng, g)
    want, new_vars = japply(jm, v, g, train=True, mutable=["batch_stats"])
    tm = common.GroupEncoder(48).train()
    tm.load_state_dict(weights.encoder_state(v["params"], v["batch_stats"], ""), strict=True)
    close(tm(t(g)), want)
    stats = new_vars["batch_stats"]
    for bn, mod in (("bn1", tm.first_conv[1]), ("bn2", tm.second_conv[1])):
        close(mod.running_mean, stats[bn]["mean"])
        close(mod.running_var, stats[bn]["var"])


@pytest.mark.parametrize("hook", [-1, 1])
def test_student_with_pinned_mask_matches_jax(rng, hook):
    cfg = tiny_cfg()
    nbr = (0.2 * rng.normal(size=(2, 16, 8, 3))).astype(np.float32)
    center = rng.normal(size=(2, 16, 3)).astype(np.float32)
    jm = JStudent(cfg)
    v = jax_variables(jm, rng, nbr, center)
    want = japply(jm, v, nbr, center, rngs=RNGS, register_shallow_hook=hook)
    mask = t(want[-1])
    assert int(mask.sum()) == 2 * int(0.8 * 16)
    tm = VisableOnlyMaskTransformer(ConfigDict(dict(cfg))).eval()
    tm.load_state_dict(weights.student_state(v["params"], v["batch_stats"], ""), strict=True)
    got = tm(t(nbr), t(center), register_shallow_hook=hook, mask=mask)
    assert len(got) == len(want)
    for g_, w_ in zip(got[:-1], want[:-1]):
        close(g_, w_)
    cls_w = japply(jm, v, nbr, center, noaug=True, only_cls_tokens=True, rngs=RNGS)
    close(tm(t(nbr), t(center), noaug=True, only_cls_tokens=True), cls_w)
