"""The PyTorch port's classifier held against the JAX package on the CPU.

Each ported module of ``models/common.py`` and the whole serving forward run
the same weights in both packages: JAX parameters are drawn, perturbed away
from their trivial init, and carried to the port by the weight bridge. Inputs
are numpy arrays from a seed.

Tolerances: f32 compares at 1e-4 (both sides are f32 throughout; only sum
order differs). bf16 rounds at the same places on both sides but each
rounding of a 1-ulp-different f32 value can land one bf16 ulp (2^-8
relative) apart, so bf16 compares at an absolute 0.02 (the small
classifier's logits, of size ~1, measured 0.007 apart at most) and requires
the same argmax.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from act_tpu.engine import checkpoint as jckpt
from act_tpu.engine import export as jexport
from act_tpu.engine import torch_convert as tc
from act_tpu.models import common as jcommon
from act_tpu.models.point_transformer import Mlp3Head as JMlp3Head
from act_tpu.models.point_transformer import PointTransformer as JPointTransformer
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch.engine import weights
from act_tpu_torch.engine.serve import build_infer_fn, load_model
from act_tpu_torch.models import common
from act_tpu_torch.utils.config import ConfigDict

KEY = jax.random.PRNGKey(0)
RNGS = dict(params=KEY, dropout=KEY, droppath=KEY)
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_ATOL = 0.02


def perturb(tree, rng):
    """Random biases, scales, tokens and BN statistics, so a wrong mapping
    cannot hide behind zeros and ones."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if name in ("bias", "cls_token", "side_alpha"):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return a.astype(np.float32)
    return walk(jax.device_get(tree))


def jax_variables(module, rng, *inputs, **kw):
    variables = module.init(RNGS, *[jnp.asarray(x) for x in inputs], **kw)
    return {k: perturb(v, rng) for k, v in jax.device_get(variables).items()}


def port(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def close(got: torch.Tensor, want, dtype_name, atol=1e-4):
    got = got.float().detach().numpy()
    want = np.asarray(want, np.float32)
    if dtype_name == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlp(rng, dt):
    jdt, tdt = DTYPES[dt]
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    jm = jcommon.Mlp(96, dtype=jdt)
    v = jax_variables(jm, rng, x)
    tm = port(common.Mlp(24, 96, dtype=tdt), weights.mlp_state(v["params"], ""))
    close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention(rng, dt):
    jdt, tdt = DTYPES[dt]
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    jm = jcommon.Attention(3, dtype=jdt)
    v = jax_variables(jm, rng, x)
    tm = port(common.Attention(24, 3, dtype=tdt),
              weights.attention_state(v["params"], ""))
    out = tm(torch.from_numpy(x))
    want = jm.apply(v, jnp.asarray(x))
    assert out.dtype == (tdt or torch.float32) and want.dtype == (jdt or jnp.float32)
    close(out, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_block(rng, dt):
    jdt, tdt = DTYPES[dt]
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    jm = jcommon.Block(3, dtype=jdt)
    v = jax_variables(jm, rng, x)
    tm = port(common.Block(24, 3, dtype=tdt), weights.block_state(v["params"], ""))
    out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32  # the residual stream stays f32
    close(out, jm.apply(v, jnp.asarray(x)), dt)


@pytest.mark.parametrize("scan", [False, True])
def test_transformer_encoder(rng, scan):
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    pos = rng.normal(size=(2, 9, 24)).astype(np.float32)
    jm = jcommon.TransformerEncoder(24, 3, 3, scan=scan)
    v = jax_variables(jm, rng, x, pos)
    sd = {}
    for name, blk in weights.unstack_blocks(v["params"]).items():
        sd.update(weights.block_state(blk, f"blocks.{name.split('_')[1]}"))
    tm = port(common.TransformerEncoder(24, 3, 3), sd)
    want, _ = jm.apply(v, jnp.asarray(x), jnp.asarray(pos))
    close(tm(torch.from_numpy(x), torch.from_numpy(pos))[0], want, "f32")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pos_embed(rng, dt):
    jdt, tdt = DTYPES[dt]
    c = rng.normal(size=(2, 16, 3)).astype(np.float32)
    jm = jcommon.PosEmbedMLP(24, dtype=jdt)
    v = jax_variables(jm, rng, c)
    tm = port(common.PosEmbedMLP(24, dtype=tdt),
              weights.pos_embed_state(v["params"], ""))
    close(tm(torch.from_numpy(c)), jm.apply(v, jnp.asarray(c)), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_group_encoder(rng, dt):
    jdt, tdt = DTYPES[dt]
    g = (0.1 * rng.normal(size=(2, 16, 8, 3))).astype(np.float32)
    jm = jcommon.GroupEncoder(48, dtype=jdt)
    v = jax_variables(jm, rng, g)
    sd = weights.encoder_state(v["params"], v["batch_stats"], "")
    assert sd["first_conv.0.weight"].shape == (128, 3, 1)
    assert not sd["first_conv.0.bias"].any() and not sd["second_conv.0.bias"].any()
    tm = port(common.GroupEncoder(48, dtype=tdt), sd)
    out = tm(torch.from_numpy(g))
    assert out.dtype == (tdt or torch.float32)
    close(out, jm.apply(v, jnp.asarray(g)), dt)


def test_mlp3_head(rng):
    from act_tpu_torch.models.point_transformer import Mlp3Head
    x = rng.normal(size=(4, 48)).astype(np.float32)
    jm = JMlp3Head(10)
    v = jax_variables(jm, rng, x)
    tm = port(Mlp3Head(48, 10), weights.mlp3_head_state(v["params"], v["batch_stats"], ""))
    close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)), "f32")


# ---------------------------------------------------------------------------
# the slice: the serving forward of the small classifier
# ---------------------------------------------------------------------------

N_IN, NPOINTS = 512, 256


def small_cfg(transfer="mlp-3", dtype=None, scan=False):
    return dict(NAME="PointTransformer", embed_dim=48, depth=2, drop_path_rate=0.1,
                cls_dim=10, num_heads=3, group_size=8, num_group=16,
                encoder_dims=48, transfer_type=transfer, dtype=dtype, scan=scan)


def jax_classifier(model_cfg, rng):
    jm = JPointTransformer(JConfigDict(model_cfg))
    v = jax_variables(jm, rng, np.zeros((2, NPOINTS, 3), np.float32))
    return jm, v


def port_classifier(model_cfg, v):
    cfg = ConfigDict(dict(npoints=NPOINTS, model=model_cfg))
    sd = weights.flax_to_state_dict(v["params"], v["batch_stats"])
    return load_model(cfg, sd, device="cpu")


@pytest.mark.parametrize("transfer,dt", [("mlp-3", "f32"), ("linear", "f32"),
                                         ("side", "f32"), ("mlp-3", "bf16"),
                                         ("linear", "bf16")])
def test_serving_forward_matches_jax(rng, transfer, dt):
    model_cfg = small_cfg(transfer, None if dt == "f32" else "bf16")
    jm, v = jax_classifier(model_cfg, rng)
    pts = rng.normal(size=(3, N_IN, 3)).astype(np.float32)
    want = np.asarray(jexport.build_infer_fn(jm, v, NPOINTS)(jnp.asarray(pts)))
    model = port_classifier(model_cfg, v)
    got = build_infer_fn(model, NPOINTS)(pts)
    assert got.shape == (3, 10) and got.dtype == torch.float32
    close(got, want, dt)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


def test_extract_feature_matches_jax(rng):
    jm, v = jax_classifier(small_cfg(), rng)
    pts = rng.normal(size=(2, NPOINTS, 3)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(pts), method=jm.extract_feature)
    model = port_classifier(small_cfg(), v)
    with torch.inference_mode():
        got = model.extract_feature(torch.from_numpy(pts))
    close(got, want, "f32")


def test_reduce_dim_and_no_fps(rng):
    """encoder_dims != embed_dim adds reduce_dim; with_fps=False feeds the
    cloud as it is."""
    model_cfg = dict(small_cfg(), encoder_dims=32)
    jm, v = jax_classifier(model_cfg, rng)
    pts = rng.normal(size=(2, NPOINTS, 3)).astype(np.float32)
    want = jexport.build_infer_fn(jm, v, NPOINTS, with_fps=False)(jnp.asarray(pts))
    model = port_classifier(model_cfg, v)
    close(build_infer_fn(model, NPOINTS, with_fps=False)(pts), want, "f32")
    with pytest.raises(ValueError):
        build_infer_fn(model, NPOINTS, with_fps=False)(pts[:, :100])


@pytest.mark.parametrize("head", ["mlp-3", "linear"])
@pytest.mark.parametrize("scan", [False, True])
def test_bridge_round_trip(rng, head, scan):
    """flax -> bridge -> torch_convert.convert_state_dict gives back the flax
    tree (the scanned stack comes back as per-block subtrees)."""
    _, v = jax_classifier(small_cfg(head, scan=scan), rng)
    sd = weights.flax_to_state_dict(v["params"], v["batch_stats"])
    assert sd["encoder.first_conv.0.weight"].shape == (128, 3, 1)
    assert sd["blocks.blocks.1.attn.qkv.weight"].shape == (144, 48)
    params, bs = tc.convert_state_dict({k: x.numpy() for k, x in sd.items()},
                                       tc.point_transformer_rules(head))
    want = v["params"]
    if scan:
        _, unrolled = jax_classifier(small_cfg(head, scan=False), rng)
        want = jckpt.adapt_block_layout(want, unrolled["params"])
    flat = jckpt.flatten_keys
    got_p, want_p = flat(params), flat(want)
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        np.testing.assert_array_equal(got_p[k], want_p[k], err_msg=k)
    got_bs, want_bs = flat(bs), flat(v["batch_stats"])
    assert sorted(got_bs) == sorted(want_bs)
    for k in want_bs:
        np.testing.assert_array_equal(got_bs[k], want_bs[k], err_msg=k)


def test_port_state_dict_is_the_reference_layout(rng):
    """The port's own keys and shapes are those the bridge emits, so a
    reference checkpoint loads with strict=True; a .pth round-trips."""
    _, v = jax_classifier(small_cfg(), rng)
    sd = weights.flax_to_state_dict(v["params"], v["batch_stats"])
    model = load_model(ConfigDict(dict(npoints=NPOINTS, model=small_cfg())),
                       seed=3, device="cpu")
    own = model.state_dict()
    assert {k: tuple(x.shape) for k, x in own.items()} == \
        {k: tuple(x.shape) for k, x in sd.items()}
    for key in ("cls_head_finetune.0.weight", "cls_head_finetune.1.running_var",
                "cls_head_finetune.8.bias", "blocks.blocks.0.attn.proj.weight"):
        assert key in own


def test_pth_checkpoint_loads(rng, tmp_path):
    model_cfg = small_cfg()
    _, v = jax_classifier(model_cfg, rng)
    sd = weights.flax_to_state_dict(v["params"], v["batch_stats"])
    path = tmp_path / "ckpt.pth"
    torch.save({"base_model": {f"module.{k}": x for k, x in sd.items()}}, path)
    cfg = ConfigDict(dict(npoints=NPOINTS, model=model_cfg))
    a = load_model(cfg, str(path), device="cpu")
    b = load_model(cfg, sd, device="cpu")
    for k, x in a.state_dict().items():
        torch.testing.assert_close(x, b.state_dict()[k], rtol=0, atol=0)


def test_seeded_init_is_deterministic():
    cfg = ConfigDict(dict(npoints=NPOINTS, model=small_cfg()))
    a, b, c = (load_model(cfg, seed=s, device="cpu") for s in (1, 1, 2))
    pa, pb, pc = (m.state_dict()["blocks.blocks.0.mlp.fc1.weight"] for m in (a, b, c))
    assert torch.equal(pa, pb) and not torch.equal(pa, pc)
    assert torch.all(torch.isfinite(pa))


def test_default_device_without_card_raises():
    """No hidden fallback: the entry point defaults to the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = ConfigDict(dict(npoints=NPOINTS, model=small_cfg()))
    with pytest.raises(RuntimeError, match="cuda"):
        load_model(cfg)


def test_train_mode_refused():
    """Training mode without the generators it draws from is refused (drop
    path at 0.1 draws from 'droppath'); the finetune tests cover training."""
    model = load_model(ConfigDict(dict(npoints=NPOINTS, model=small_cfg())),
                       device="cpu").train()
    with pytest.raises(ValueError, match="droppath"):
        model(torch.zeros(1, NPOINTS, 3))
