"""The port's FLOPs and parameters report held against the JAX tool on the CPU.

``act_tpu_torch.get_flops`` against ``tools/get_flops.py``'s way of counting:
JAX's ``params`` from ``jax.eval_shape`` of ``model.init`` (nothing compiled)
for every shipped model YAML, equal to the port's count exactly; the forward's
FLOPs within [0.90, 1.02] of XLA's ``cost_analysis()["flops"]`` (XLA counts
elementwise operations too; ``FlopCounterMode`` counts products, and
``ops/work.py`` the kernels), at full width for two configs and at 2 blocks,
widths kept, for the Stage-II model (JAX applied with ``mutable``, as the
JAX tool does not) and the ViT dVAE. Each kernel's formula gives one count
through its registered op and through its plain version.
"""
import glob

import numpy as np
import pytest
import flax
import jax
import jax.numpy as jnp
import torch
from torch.utils.flop_counter import FlopCounterMode

from act_tpu.models import MODELS as JMODELS
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch import get_flops, ops
from act_tpu_torch.engine.serve import load_config
from act_tpu_torch.models import MODELS
from act_tpu_torch.ops import work
from act_tpu_torch.ops.rows import gather_rows_bwd

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

MODEL_YAMLS = sorted(glob.glob("cfgs/autoencoder/*.yaml") + glob.glob("cfgs/pretrain/*.yaml")
                     + glob.glob("cfgs/finetune_classification/full/*.yaml")
                     + glob.glob("cfgs/finetune_classification/linear/*.yaml")
                     + glob.glob("cfgs/finetune_classification/mlp3/*.yaml"))
FINETUNE = "cfgs/finetune_classification/full/finetune_modelnet.yaml"
PLAIN_DVAE = "cfgs/autoencoder/pointbert_dvae.yaml"
VIT_DVAE = "cfgs/autoencoder/act_dvae_with_pretrained_transformer.yaml"
PRETRAIN = "cfgs/pretrain/pretrain_act_distill.yaml"
XLA_RATIO = (0.90, 1.02)
# the JAX tool's streams and input (tools/get_flops.py:31-34)
KEY = jax.random.PRNGKey(0)
RNGS = dict(params=KEY, gumbel=KEY, mask=KEY, dropout=KEY, droppath=KEY)


def two_blocks(path):
    """The YAML's config with every transformer cut to 2 blocks, widths kept."""
    cfg = load_config(path)
    m = cfg.model
    if "transformer_config" in m:
        m.transformer_config.depth = 2
        m.transformer_config.register_shallow_hook = 1
        m = m.dvae_config
    m.visual_embed_depth = 2
    return cfg


def jax_model(cfg):
    """The JAX model of ``cfg``, its variables' shapes and its params count."""
    model = JMODELS.build(JConfigDict(dict(cfg)).model)
    pts = jnp.zeros((1, 1024, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(RNGS, pts))
    return model, shapes, sum(int(np.prod(x.shape))
                              for x in jax.tree_util.tree_leaves(shapes["params"]))


def xla_flops(model, shapes, mutable=False):
    """XLA's cost analysis of the forward, compiled as the JAX tool does."""
    kw = dict(mutable=["batch_stats"]) if mutable else {}
    lowered = jax.jit(lambda v, p: model.apply(v, p, rngs=RNGS, **kw)).lower(
        shapes, jnp.zeros((1, 1024, 3), jnp.float32))
    cost = lowered.compile().cost_analysis()
    return (cost[0] if isinstance(cost, list) else cost)["flops"]


def test_the_shipped_model_yamls():
    assert len(MODEL_YAMLS) == 18


@pytest.mark.parametrize("path", MODEL_YAMLS)
def test_params_equal_jax(path):
    cfg = load_config(path)
    with torch.device("meta"):
        model = MODELS.build(cfg.model)
    assert get_flops.params(model) == jax_model(cfg)[2]


@pytest.mark.parametrize("path,cut,kernels", [
    (FINETUNE, False, {"fps", "k_smallest", "gather"}),
    (PLAIN_DVAE, False, {"fps", "k_smallest", "gather"}),
    (VIT_DVAE, True, {"fps", "k_smallest", "gather"}),
    (PRETRAIN, True, {"fps", "k_smallest", "gather", "gumbel_argmax"})])
def test_flops_against_xla(path, cut, kernels):
    """Params equal, FLOPs within XLA_RATIO of XLA's, and each kernel the
    forward runs counted by its formula; the Stage-II model in training
    mode (JAX: ``mutable=["batch_stats"]``)."""
    cfg = two_blocks(path) if cut else load_config(path)
    got = get_flops.count(get_flops.build(cfg, device="cpu"))
    model, shapes, n = jax_model(cfg)
    want = xla_flops(model, shapes, mutable=path == PRETRAIN)
    assert got.params == n
    assert set(got.kernel_flops) == kernels
    assert got.kernel_flops["fps"] == work.fps(1, 1024, int(cfg.model.get("num_group") or 64))
    assert got.flops == got.aten_flops + sum(got.kernel_flops.values())
    assert XLA_RATIO[0] <= got.flops / want <= XLA_RATIO[1], got.flops / want


def test_stage_two_model_raises_in_the_jax_tool_and_is_counted_here():
    """``tools/get_flops.py`` applies the model without ``mutable`` (its line
    38), and the Stage-II forward updates BatchNorm statistics: flax raises.
    The port counts that forward in training mode."""
    cfg = two_blocks(PRETRAIN)
    model, shapes, _ = jax_model(cfg)
    with pytest.raises(flax.errors.ModifyScopeVariableError, match="batch_stats"):
        jax.jit(lambda v, p: model.apply(v, p, rngs=RNGS)).lower(
            shapes, jnp.zeros((1, 1024, 3), jnp.float32))
    got = get_flops.count(get_flops.build(cfg, device="cpu"))
    assert got.flops > 0 and got.kernel_flops["gumbel_argmax"] == work.gumbel_argmax(64, 8192)


@pytest.mark.parametrize("path,match", [
    ("cfgs/finetune_classification/few_shot/fewshot_modelnet.yaml", "cls_dim"),
    ("cfgs/tsne/tsne_scan_hardest.yaml", "no 'model' node")])
def test_yamls_without_a_countable_model_raise(path, match):
    with pytest.raises(ValueError, match=match):
        get_flops.build(path, device="cpu")


def test_cli_prints_the_jax_tools_four_lines(capsys):
    get_flops.main(["--config", FINETUNE, "--npoints", "256", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == ["Model:", "Input:", "Params:", "FLOPs:"]
    assert lines[0].endswith("PointTransformer") and lines[1].endswith("(1, 256, 3)")
    assert lines[2] == "Params: 22.10 M" and "GFLOPs (torch FlopCounterMode" in lines[3]


def clouds(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def through_op(op, *args):
    with FlopCounterMode(display=False) as fc:
        op(*args)
    return {str(k): v for k, v in fc.get_flop_counts().get("Global", {}).items()}


def through_wrapper(fn, *args):
    with work.Work() as w:
        fn(*args)
    return w.flops


@pytest.mark.parametrize("name", ["fps", "k_smallest", "gather"])
def test_registered_op_formula_equals_plain_path(name):
    """A registered op's formula counted by FlopCounterMode at the op (the
    card's path; its CPU implementation runs here) equals what its wrapper
    records on the plain path, and the plain version itself counts 0."""
    x = clouds(2, 100, 3)
    start = torch.zeros(2, dtype=torch.int32)
    idx = ops.furthest_point_sample(x, 10)
    d = clouds(6, 50)
    case = {"fps": (torch.ops.act_tpu_torch.fps, (x, start, 10), ops.furthest_point_sample,
                    (x, 10), work.fps(2, 100, 10)),
            "k_smallest": (torch.ops.act_tpu_torch.k_smallest, (d, 4), ops.k_smallest, (d, 4), 0),
            "gather": (torch.ops.act_tpu_torch.gather, (x, idx), ops.gather_coords, (x, idx), 0)}
    op, op_args, wrapper, args, want = case[name]
    assert through_op(op, *op_args) == {f"act_tpu_torch.{name}": want}
    assert through_wrapper(wrapper, *args) == {name: want}
    assert through_op(wrapper, *args) == {}  # the plain path: the wrapper's record alone
    assert name != "fps" or want == 10 * 2 * 100 * 9


def test_plain_wrapper_formulas():
    """The Gumbel, Chamfer and row-gather wrappers record their formulas on
    the plain path (on the card the same line records them before the
    launch), and their plain versions count 0 in FlopCounterMode."""
    logits = clouds(2, 3, 64)
    seed = torch.zeros(2, dtype=torch.int32)
    x, y = clouds(2, 20, 3), clouds(2, 30, 3, seed=1)
    d1, d2, i1, i2 = ops.chamfer.nn_pair(x, y)
    grad = clouds(2, 40, 5)
    index = ops.row_index(torch.randint(0, 8, (2, 40), dtype=torch.int32), 8)
    cases = [("gumbel_argmax", ops.gumbel_argmax, (logits, seed), 24 * 6 * 64),
             ("chamfer_nn", ops.chamfer.nn_pair, (x, y), 10 * 2 * 20 * 30),
             ("chamfer_nn_min", ops.chamfer.nn_pair_min, (x, y), 10 * 2 * 20 * 30),
             ("chamfer_bwd", ops.chamfer.chamfer_bwd, (x, y, i1, i2, d1, d2), 15 * 2 * 50),
             ("row_gather_bwd", gather_rows_bwd, (grad, index), 2 * 40 * 5)]
    for name, fn, args, want in cases:
        assert work.FORMULAS[name](*{"gumbel_argmax": (6, 64), "row_gather_bwd": (2, 40, 5)}.get(
            name, (2, 20, 30))) == want
        assert through_wrapper(fn, *args) == {name: want}, name
        assert through_op(fn, *args) == {}, name
