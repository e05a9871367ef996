"""The port's Stage-II model held against the JAX package on the CPU.

The whole ``ACT_PointDistillation`` loss runs the same weights in both
packages (its modules one by one: ``test_torch_port_layers.py``): JAX
parameters are drawn,
perturbed away from their trivial init, and carried to the port by the weight
bridge; masks and Gumbel draws are pinned by replaying what the flax model
sows. Inputs are numpy arrays from a seed. Sizes are small (2 student
blocks, a 2-block teacher 48 wide with 4 prompts, G=16, M=8).

Tolerances: f32 compares at atol 1e-5 (both sides are f32 throughout; only
sum order differs), indices exactly. Under ``dtype: bf16`` both sides round
at the same places, but a 1-ulp-different f32 value may round to bf16 values
one bf16 ulp (2^-8 relative) apart; the loss, a mean of cosines of size ~1,
compares at an absolute 0.005 (4e-4 apart measured).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from act_tpu.engine import checkpoint as jckpt
from act_tpu.engine import torch_convert as tc
from act_tpu.models import ACT_PointDistillation as JDistill

from act_tpu_torch.engine import weights
from act_tpu_torch.models import ACT_PointDistillation
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_fullgraph import TorchDistill
from tests.test_torch_fullgraph import tiny_distill_cfg as fullgraph_cfg
from tests.test_torch_port_model import perturb

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5
BF16_ATOL = 0.005
KEY = jax.random.PRNGKey(0)
RNGS = dict(params=KEY, gumbel=jax.random.PRNGKey(1), mask=jax.random.PRNGKey(2),
            dropout=jax.random.PRNGKey(3), droppath=jax.random.PRNGKey(4))


def close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=atol)


def jax_variables(module, rng, *inputs, **kw):
    """Perturbed variables of a flax module; ``init`` jitted (eager init of
    the distillation graph takes tens of seconds on the CPU)."""
    init = jax.jit(lambda *xs: module.init(RNGS, *xs, **kw))
    v = init(*[jnp.asarray(x) for x in inputs])
    return {k: perturb(x, rng) for k, x in jax.device_get(v).items()}


def japply(module, v, *inputs, **kw):
    """``module.apply`` jitted (eager JAX compiles op by op)."""
    return jax.jit(lambda v, *xs: module.apply(v, *xs, **kw))(
        v, *[jnp.asarray(x) for x in inputs])


def tiny_cfg(**tc_over):
    """``__graft_entry__._pretrain_cfg(tiny=True)`` with drop path off."""
    cfg = graft._pretrain_cfg(tiny=True)
    cfg.transformer_config.drop_path_rate = 0.0
    cfg.transformer_config.update(tc_over)
    return cfg


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the whole Stage-II graph
# ---------------------------------------------------------------------------

def jax_distill(cfg, rng, pts):
    jm = JDistill(cfg)
    v = jax_variables(jm, rng, pts)
    out, inter = japply(jm, v, pts, train=False, rngs=RNGS, mutable=["intermediates"])
    ii = inter["intermediates"]
    return v, float(out), t(ii["mask"][0]), t(ii["dvae_tokenizer"]["gumbel_u"][0])


@pytest.mark.parametrize("variant", ["f32", "cls_loss", "bf16"])
def test_distillation_loss_matches_jax(rng, variant):
    """The loss at train=False with the sown mask and Gumbel draws replayed,
    through the weight bridge; the tokenizer's Gumbel ids also come out of
    ``forward_tokenizer_features`` without replay on the CPU path."""
    over = {"cls_loss": True} if variant == "cls_loss" else {}
    cfg = tiny_cfg(**over)
    if variant == "bf16":
        cfg.transformer_config.dtype = "bf16"
        cfg.dvae_config.dtype = "bf16"
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    v, want, mask, u = jax_distill(cfg, rng, pts)
    model = ACT_PointDistillation(ConfigDict(dict(cfg))).eval()
    model.load_state_dict(weights.distillation_state_dict(v["params"], v["batch_stats"]),
                          strict=True)
    with torch.no_grad():
        got = float(model(t(pts), mask=mask, gumbel_u=u))
    np.testing.assert_allclose(got, want, atol=BF16_ATOL if variant == "bf16" else ATOL)


def test_scanned_jax_stacks_bridge_and_round_trip(rng):
    """flax (scanned student/decoder stacks) -> distillation_state_dict ->
    torch_convert.convert_state_dict gives back the unrolled flax tree, and
    the port's own state dict has exactly the bridge's keys and shapes."""
    cfg = tiny_cfg(scan=True)
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    jm = JDistill(cfg)
    v = jax_variables(jm, rng, pts)
    sd = weights.distillation_state_dict(v["params"], v["batch_stats"])
    own = ACT_PointDistillation(ConfigDict(dict(cfg))).state_dict()
    assert {k: tuple(x.shape) for k, x in own.items()} == \
        {k: tuple(x.shape) for k, x in sd.items()}
    params, bs = tc.convert_state_dict({k: x.numpy() for k, x in sd.items()},
                                       tc.act_distillation_rules())
    unrolled = jax.eval_shape(lambda p: JDistill(tiny_cfg(scan=False)).init(RNGS, p),
                              jnp.asarray(pts))
    want = jckpt.adapt_block_layout(v["params"], unrolled["params"])
    flat = jckpt.flatten_keys
    got_p, want_p = flat(params), flat(want)
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        np.testing.assert_array_equal(got_p[k], want_p[k], err_msg=k)
    got_bs, want_bs = flat(bs), flat(v["batch_stats"])
    assert sorted(got_bs) == sorted(want_bs)
    for k in want_bs:
        np.testing.assert_array_equal(got_bs[k], want_bs[k], err_msg=k)


def test_reference_checkpoint_layout_loads_strictly():
    """A reference ACT_PointDistillation state dict (the torch rebuild of
    tests/test_torch_fullgraph.py) loads with strict=True once its FoldingNet
    ``dvae_tokenizer.decoder.*`` keys, which Stage II never runs, are
    dropped."""
    torch.manual_seed(0)
    ref = TorchDistill().state_dict()
    assert any(k.startswith("dvae_tokenizer.decoder.") for k in ref)
    sd = {k: x for k, x in ref.items() if not k.startswith("dvae_tokenizer.decoder.")}
    ACT_PointDistillation(fullgraph_cfg()).load_state_dict(sd, strict=True)


def test_seeded_init_follows_the_jax_initializers():
    model = ACT_PointDistillation(ConfigDict(dict(tiny_cfg())))
    model.init_weights(torch.Generator().manual_seed(0))
    tok = model.dvae_tokenizer
    assert abs(float(tok.codebook.detach().std()) - 1.0) < 0.1
    assert float(tok.visual_prompt_token.abs().max()) <= 0.04 + 1e-6
    assert float(model.mask_token.abs().max()) <= 0.04 + 1e-6
    assert torch.equal(tok.dgcnn_1.layer1[1].weight, torch.ones(256))
    w = model.ACT_encoder.blocks.blocks[0].mlp.fc1.weight
    assert abs(float(w.detach().std()) * np.sqrt(w.shape[1]) - 1.0) < 0.15
    assert not model.ACT_encoder.encoder.first_conv[0].bias.requires_grad
