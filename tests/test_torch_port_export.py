"""The port's serving artifacts (``act_tpu_torch/engine/export.py``) on the CPU.

Each kind exported with ``device="cpu"`` at a concrete and a symbolic batch,
saved, reloaded through ``load_exported`` and held bit-equal to its direct
serving function at B=1 and 3; the classifier artifact against the JAX
package's ``export_classifier`` artifact on the same (bridged) weights; the
three registered kernel ops through ``torch.library.opcheck``; a graph of
the ops exported, saved and reloaded in a fresh process that imports only
``act_tpu_torch.ops``; the sidecar; ``serve_http --src`` against the config
path; the CLI.
"""
import json
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from act_tpu.engine import export as jex
from act_tpu.models import MODELS as JMODELS
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch import serve_http
from act_tpu_torch.engine import export as ex
from act_tpu_torch.engine.serve import (build_features_fn, build_infer_fn, build_recon_fn,
                                        build_tokenize_fn, load_model, load_seg_model)
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_pointbert import bert_model_cfg, probe_node, train_cfg
from tests.test_torch_port_serve import request
from tests.test_torch_port_stage1 import smoke_cfg
from tests.test_torch_port_teachers import drawn_variables

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

NPOINTS = 8
N_IN = 10  # the classifier's and the features' FPS resample: 10 -> 8 points
CLS = dict(NAME="PointTransformer", embed_dim=32, depth=1, drop_path_rate=0.0, cls_dim=10,
           num_heads=2, group_size=4, num_group=4, encoder_dims=32, transfer_type="mlp-3")
SEG_NPOINT, SEG_G = 32, 4  # the segmentation models group 32 points
SEG_WIDTHS = dict(trans_dim=32, depth=1, num_heads=2, encoder_dims=32, fetch_idx=(0,))


def cls_cfg():
    return ConfigDict(dict(npoints=NPOINTS, model=dict(CLS)))


def dvae_cfg():
    cfg = smoke_cfg()
    cfg.npoints = NPOINTS
    cfg.model.num_group, cfg.model.group_size = 4, 4
    cfg.model.visual_embed_depth = 1
    return cfg


def features_cfg():
    cfg = train_cfg(bert_model_cfg())
    cfg.model.transformer_config.depth = 1
    cfg.model.dvae_config.num_group = cfg.model.dvae_config.group_size = 4
    cfg.dataset = ConfigDict(dict(val=probe_node("test")))
    cfg.npoints = NPOINTS
    return cfg


def features_model():
    from act_tpu_torch.engine.runner_pretrain import build_pretrain_model
    return build_pretrain_model(features_cfg().model, 0).eval()


def inputs(kind, b, n, seed=0):
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(b, n, 3)).astype(np.float32)]
    if kind == "partseg":
        x.append(np.eye(16, dtype=np.float32)[rng.integers(0, 16, b)])
    return x


def jax_classifier():
    """JAX's classifier of ``CLS`` (the module ``export_classifier`` builds)
    with variables drawn in numpy at its init's shapes (no init program to
    compile), and those weights as a port state dict through the bridge."""
    from act_tpu_torch.engine import weights

    model = JMODELS.build(JConfigDict(dict(CLS)))
    v = drawn_variables(model, np.random.default_rng(0), np.zeros((2, NPOINTS, 3), np.float32))
    return model, v, weights.flax_to_state_dict(v["params"], v["batch_stats"])


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The artifacts exported on the CPU, saved and loaded once:
    {(kind, batch): (path, loaded callable)} (batch None: symbolic), and the
    direct serving functions {kind: (fn, input points)}. The classifier
    carries JAX's weights (``--ckpts`` of a bridged ``.pth``) and
    its symbolic artifact comes from ``export_model export``; the dvae kind
    exists at a fixed batch only; segmentation is a narrow part-segmentation
    model (``SEG_WIDTHS``; phase 37 of ``chip_smoke.py`` exports both tasks
    at full width on the card). Every artifact is saved with no meta but
    its export's own."""
    from act_tpu_torch import export_model

    out = tmp_path_factory.mktemp("artifacts")
    jax_model, jax_vars, sd = jax_classifier()
    pth, yaml = str(out / "cls.pth"), str(out / "cls.yaml")
    torch.save(sd, pth)
    with open(yaml, "w") as f:
        json.dump(dict(npoints=NPOINTS, model=CLS), f)
    export_model.main(["export", "--config", yaml, "--ckpts", pth, "--n_in", str(N_IN),
                       "--dst", str(out / "classifier-None.pt2"), "--device", "cpu"])
    made = {
        ("classifier", 3): lambda: ex.export_classifier(cls_cfg(), sd, batch=3, n_in=N_IN,
                                                        device="cpu"),
        ("features", 3): lambda: ex.export_features(features_cfg(), batch=3, n_in=N_IN,
                                                    device="cpu"),
        ("features", None): lambda: ex.export_features(features_cfg(), n_in=N_IN,
                                                       device="cpu"),
        ("tokenize", 3): lambda: ex.export_dvae_tokenize(dvae_cfg(), batch=3, device="cpu"),
        ("tokenize", None): lambda: ex.export_dvae_tokenize(dvae_cfg(), device="cpu"),
        ("dvae", 3): lambda: ex.export_dvae_recon(dvae_cfg(), batch=3, device="cpu"),
        ("partseg", 3): lambda: ex.export_segmentation(
            "partseg", SEG_NPOINT, batch=3, num_group=SEG_G, device="cpu", widths=SEG_WIDTHS),
        ("partseg", None): lambda: ex.export_segmentation(
            "partseg", SEG_NPOINT, num_group=SEG_G, device="cpu", widths=SEG_WIDTHS),
    }
    for (kind, b), export in made.items():
        ex.save_exported(export(), str(out / f"{kind}-{b}.pt2"))
    loaded = {key: (str(out / f"{key[0]}-{key[1]}.pt2"),
                    ex.load_exported(str(out / f"{key[0]}-{key[1]}.pt2"), device="cpu"))
              for key in [("classifier", None), *made]}
    dvae = load_model(dvae_cfg(), device="cpu")
    direct = {
        "classifier": (build_infer_fn(load_model(cls_cfg(), sd, device="cpu"), NPOINTS), N_IN),
        "features": (build_features_fn(features_model(), NPOINTS), N_IN),
        "tokenize": (build_tokenize_fn(dvae, NPOINTS), NPOINTS),
        "dvae": (build_recon_fn(dvae, NPOINTS), NPOINTS),
        "partseg": (build_infer_fn(load_seg_model("partseg", num_group=SEG_G, device="cpu",
                                                  widths=SEG_WIDTHS), SEG_NPOINT, False),
                    SEG_NPOINT),
    }
    return loaded, direct, out, (jax_model, jax_vars)


@pytest.mark.parametrize("kind", ["classifier", "features", "tokenize", "dvae", "partseg"])
def test_artifact_is_bit_equal_to_the_direct_call(kind, artifacts):
    """Each reloaded CPU artifact equals the direct serving function bit for
    bit (token ids exactly): a fixed batch at its size, a symbolic one at
    B=1 and 3; a CPU export's graph holds no kernel op. The dvae kind
    raises for a symbolic batch."""
    loaded, direct = artifacts[:2]
    fn, n = direct[kind]
    for (k, batch), (_, art) in loaded.items():
        if k != kind:
            continue
        assert not art.meta["needs_ops"]
        for b in ((1, 3) if batch is None else (batch,)):
            x = inputs(kind, b, n, seed=b)
            got, want = art(*x), fn(*x)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, want), (kind, batch, b)
    if kind == "dvae":
        with pytest.raises(ValueError, match="fixed --batch"):
            ex.export_dvae_recon(dvae_cfg(), device="cpu")


def test_sidecar_fields(artifacts):
    """The sidecar names the magic, the shapes (a symbolic batch by name),
    dtypes, device, whether the kernel ops are needed, and the export's own
    meta (kind, npoints, n_in, with_fps, config, ckpts; the part-segmentation
    one-hot's width), with no meta given to ``save_exported``; an input of
    another shape or a wrong device raises."""
    loaded, out = artifacts[0], artifacts[2]
    side = loaded["classifier", None][1].meta
    assert side["magic"] == ex.MAGIC and side["bytes"] > 0
    assert side["in_shapes"] == [["batch", N_IN, 3]] and side["out_shape"] == ["batch", 10]
    assert side["in_dtype"] == side["out_dtype"] == "float32" and side["device"] == "cpu"
    assert side["needs_ops"] is False and side["kind"] == "classifier" and side["with_fps"]
    assert (side["npoints"], side["n_in"]) == (NPOINTS, N_IN)
    assert side["config"] == str(out / "cls.yaml") and side["ckpts"] == str(out / "cls.pth")
    tok = loaded["tokenize", 3][1].meta
    assert tok["in_shapes"] == [[3, NPOINTS, 3]] and tok["out_dtype"] == "int32"
    assert (tok["kind"], tok["npoints"], tok["n_in"], tok["with_fps"]) == (
        "tokenize", NPOINTS, NPOINTS, False)
    feat = loaded["features", None][1].meta
    assert (feat["kind"], feat["npoints"], feat["n_in"], feat["with_fps"]) == (
        "features", NPOINTS, N_IN, True)
    seg = loaded["partseg", None][1].meta
    assert seg["in_shapes"] == [["batch", SEG_NPOINT, 3], ["batch", 16]]
    assert (seg["kind"], seg["seg_task"], seg["num_categories"], seg["n_in"]) == (
        "segmentation", "partseg", 16, SEG_NPOINT)
    with pytest.raises(ValueError, match="shape"):
        loaded["classifier", None][1](np.zeros((2, N_IN + 1, 3), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ex.load_exported(loaded["classifier", None][0])


def test_classifier_artifact_matches_jax_artifact(artifacts, tmp_path):
    """The port's classifier artifact (f32, symbolic batch, FPS resample of
    10-point clouds, JAX's weights through the bridge) within 1e-5 of the
    JAX package's classifier artifact (``export_classifier``'s program on
    the same variables: ``build_infer_fn`` exported by
    ``_export_point_fn``) through its ``load_exported``; the same argmax."""
    import jax.numpy as jnp

    jax_model, jax_vars = artifacts[3]
    jdst = str(tmp_path / "jax.actx")
    jart = jex._export_point_fn(jex.build_infer_fn(jax_model, jax_vars, NPOINTS), N_IN, None,
                                None)
    jex.save_exported(jart, jdst, {"kind": "classifier"})
    x = inputs("classifier", 3, N_IN)[0]
    want = np.asarray(jex.load_exported(jdst)(jnp.asarray(x)))
    got = artifacts[0]["classifier", None][1](x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("op", ["fps", "k_smallest", "gather"])
def test_registered_ops_pass_opcheck(op):
    """``torch.library.opcheck`` of each kernel op on CPU tensors (schema,
    fake implementation against the plain version, autograd
    registration, a symbolic trace), and the op equal to the plain version."""
    from act_tpu_torch.ops import reference

    g = torch.Generator().manual_seed(0)
    pts = torch.randn(3, 50, 3, generator=g)
    cases = {"fps": ((pts, torch.tensor([0, 4, 49], dtype=torch.int32), 9),
                     lambda p, s, n: reference.furthest_point_sample_ref(p, n, s)),
             "k_smallest": ((torch.randn(3, 5, 50, generator=g), 4), reference.k_smallest_ref),
             "gather": ((pts, torch.randint(0, 50, (3, 7, 2), generator=g).int()),
                        reference.gather_points)}
    args, ref = cases[op]
    fn = getattr(torch.ops.act_tpu_torch, op)
    torch.library.opcheck(fn, args)
    got, want = fn(*args), ref(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


OPS_GRAPH = '''
import sys, torch
import act_tpu_torch.ops  # the registration
ep = torch.export.load(sys.argv[1])
x = torch.randn(5, 40, 3, generator=torch.Generator().manual_seed(1))
out = ep.module()(x)
from act_tpu_torch.ops import reference as r
i = r.furthest_point_sample_ref(x, 8)
want = r.gather_points(x, r.k_smallest_ref(r.square_distance(r.gather_points(x, i), x), 4)[1])
assert torch.equal(out, want), "artifact differs"
assert not any(m.startswith("act_tpu_torch.models") or m.startswith("act_tpu_torch.engine")
               for m in sys.modules), "a model module was imported"
print("ok")
'''


class _OpsForward(torch.nn.Module):
    def forward(self, x):
        s = torch.zeros(x.shape[0], dtype=torch.int32)
        c = torch.ops.act_tpu_torch.gather(x, torch.ops.act_tpu_torch.fps(x, s, 8))
        d = ((c[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
        return torch.ops.act_tpu_torch.gather(x, torch.ops.act_tpu_torch.k_smallest(d, 4)[1])


def test_kernel_ops_export_symbolic_and_reload_without_models(tmp_path):
    """A graph of the three ops (FPS, gather, k-smallest, gather) exported
    with a symbolic batch keeps them as ``act_tpu_torch::*`` nodes
    (``uses_kernel_ops``), saves, and reloads in a fresh process that
    imports only ``act_tpu_torch.ops``, where it runs at B=5 (the CPU
    implementations) and equals the plain versions."""
    x = torch.zeros(2, 40, 3)
    ep = torch.export.export(_OpsForward(), (x,),
                             dynamic_shapes=({0: torch.export.Dim("batch", min=1)},))
    assert ex.uses_kernel_ops(ep)
    dst = str(tmp_path / "ops.pt2")
    torch.export.save(ep, dst)
    r = subprocess.run([sys.executable, "-c", OPS_GRAPH, dst], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


@pytest.mark.parametrize("kind", ["classifier", "tokenize", "dvae", "partseg"])
def test_serve_http_src_equals_config_path(kind, artifacts):
    """An artifact's server answers as the config path's: the same JSON for
    a good request, 400 for a cloud of another point count, non-finite
    points and a 2-D cloud, and (part segmentation) a category id out of
    range; /healthz names the kind. The classifier and part-segmentation
    artifacts are served by ``serve_http.serve(src=...)`` from the artifact
    and its sidecar alone (saved with no meta but its export's); the dVAE
    kinds' artifacts, already loaded, through ``make_server`` with their
    sidecar, as ``serve`` does. The narrow part-segmentation model's config
    path is ``make_server`` with ``seg_meta``, as ``serve(task=...)`` builds
    it."""
    loaded = artifacts[0]
    batch = None if kind in ("classifier", "tokenize", "partseg") else 3
    path, art = loaded[kind, batch]
    if kind == "classifier":
        config = serve_http.serve(cls_cfg(), ckpt_path=str(loaded[kind, None][1].meta["ckpts"]),
                                  port=0, device="cpu")
    elif kind == "partseg":
        model = load_seg_model("partseg", num_group=SEG_G, device="cpu", widths=SEG_WIDTHS)
        config = serve_http.make_server(build_infer_fn(model, SEG_NPOINT, with_fps=False),
                                        serve_http.seg_meta(model, "partseg", SEG_NPOINT),
                                        port=0)
    else:
        config = serve_http.serve(dvae_cfg(), port=0, device="cpu", kind=kind)
    if kind in ("classifier", "partseg"):
        src = serve_http.serve(src=path, port=0, device="cpu")
    else:
        src = serve_http.make_server(art, dict(art.meta), port=0)
    n = {"classifier": N_IN, "partseg": SEG_NPOINT}.get(kind, NPOINTS)
    srvs = [config, src]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in srvs]
    for th in threads:
        th.start()
    try:
        pts = inputs(kind, 3, n)[0]
        good = {"points": pts.tolist()}
        if kind == "partseg":
            good.update(cls_label=[3, 15, 0], return_log_probs=True)
        bad = pts.copy()
        bad[1, 2, 0] = np.nan
        payloads = [dict(good, points=pts[:, :n - 1].tolist()), dict(good, points=bad.tolist()),
                    dict(good, points=pts[0].tolist())]
        if kind == "partseg":
            payloads.append(dict(good, cls_label=[3, 16, 0]))
        answers = [[request(s, "/predict", good)] + [request(s, "/predict", p)[0]
                                                     for p in payloads] for s in srvs]
        assert answers[0][0][0] == 200 and answers[0][0] == answers[1][0]
        if kind == "classifier":  # the config path resamples a cloud of any size by FPS
            answers[0][1] = 400
        assert answers[0] == answers[1] and all(code == 400 for code in answers[1][1:])
        health = request(srvs[1], "/healthz")[1]
        assert health["kind"] == ("segmentation" if kind == "partseg" else kind)
    finally:
        for s in srvs:
            s.shutdown()
            s.server_close()
        for th in threads:
            th.join(timeout=10)


def test_export_model_cli(artifacts, capsys):
    """``export_model run`` of the CLI's classifier artifact; both
    subcommands default to the card and raise without one."""
    from act_tpu_torch import export_model

    loaded, out = artifacts[0], artifacts[2]
    path = loaded["classifier", None][0]
    export_model.main(["run", "--src", path, "--batch", "3", "--device", "cpu"])
    assert "logits (3, 10)" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            export_model.main(["export", "--config", str(out / "cls.yaml"), "--dst",
                               str(out / "x.pt2")])
        with pytest.raises(RuntimeError, match="cuda"):
            export_model.main(["run", "--src", path])
