"""The port's dVAE serving kinds held against the JAX package on the CPU.

``build_tokenize_fn`` and ``build_recon_fn`` against the JAX package's
``export_dvae_tokenize`` and ``export_dvae_recon`` programs
(``act_tpu/engine/export.py:150-186``: ``forward_tokenizer`` over
``ops.group_points``, and ``apply(pts, 1.0, True)`` with ``PRNGKey(0)``),
on the ViT-prompted dVAE at the JAX smoke widths (G=16, M=8, 64 tokens, the
teacher 48 wide, 2 layers, 4 heads, 4 prompts), f32, JAX parameters
drawn and perturbed (``test_torch_port_teachers.drawn_variables``) and
carried over by the weight bridge. The recon's Gumbel draws
are JAX's sown ``gumbel_u`` replayed. Token ids compare exactly, the
reconstruction at atol 1e-5 (f32, sum order only); then ``serve_http``'s
``tokenize`` and ``dvae`` kinds over a local socket.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from act_tpu import ops as jops

from act_tpu_torch import serve_http
from act_tpu_torch.engine import serve
from act_tpu_torch.engine.serve import build_recon_fn, build_tokenize_fn, load_model

from tests.test_torch_port_stage1 import JViT, build, jcfg, smoke_cfg
from tests.test_torch_port_stage2 import close, t
from tests.test_torch_port_teachers import drawn_variables

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

N_PTS = 128


@pytest.fixture(scope="module")
def dvae():
    """(cfg, JAX module, perturbed variables, the port's model, (3, 128, 3) clouds)."""
    rng = np.random.default_rng(21)
    cfg = smoke_cfg()
    cfg.npoints = N_PTS
    pts = rng.normal(size=(3, N_PTS, 3)).astype(np.float32)
    jm = JViT(jcfg(cfg).model)
    v = drawn_variables(jm, rng, pts)
    return cfg, jm, v, build(cfg, v), pts


def test_tokenize_matches_jax(dvae):
    cfg, jm, v, model, pts = dvae
    G, M = int(cfg.model.num_group), int(cfg.model.group_size)

    def tokenize(v, x):
        nbr, center = jops.group_points(x, G, M)
        return jm.apply(v, nbr, center, method=jm.forward_tokenizer)
    want = np.asarray(jax.jit(tokenize)(v, jnp.asarray(pts)))
    got = build_tokenize_fn(model, N_PTS)(pts)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, G)
    assert not model.training
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 4  # the ids are not one code


def test_recon_matches_jax(dvae, monkeypatch):
    """JAX's pinned draws replayed; then the port's own generator, seeded 0
    anew on every call, gives the same answer twice."""
    cfg, jm, v, model, pts = dvae
    ret, new = jax.jit(lambda v, x: jm.apply(
        v, x, 1.0, True, rngs=dict(gumbel=jax.random.PRNGKey(0)),
        mutable=["intermediates"]))(v, jnp.asarray(pts))
    u = t(new["intermediates"]["gumbel_u"][0])
    recon = build_recon_fn(model, N_PTS)
    own = recon(pts)
    assert torch.equal(recon(pts), own)
    with monkeypatch.context() as m:
        m.setattr(serve, "recon_uniforms", lambda model, batch, device: u)
        got = recon(pts)
    G, M = int(cfg.model.num_group), int(cfg.model.group_size)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, G * M, 3)
    close(got, ret[1])


@pytest.mark.parametrize("build_fn", [build_tokenize_fn, build_recon_fn])
def test_dvae_serving_needs_npoints(dvae, build_fn):
    """Clouds of exactly ``npoints`` points, no resample (``n_in =
    config.npoints`` in the JAX export)."""
    *_, model, pts = dvae
    fn = build_fn(model, N_PTS)
    for bad in (pts[:, :N_PTS - 1], pts[0], np.concatenate([pts, pts], 1)):
        with pytest.raises(ValueError):
            fn(bad)


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("kind", ["tokenize", "dvae"])
def test_serve_http_dvae_kinds(dvae, kind):
    """The kind's answer equals the direct call on the same seeded model; a
    cloud of another point count gets a 400."""
    cfg = dvae[0]
    server = serve_http.serve(cfg, None, "127.0.0.1", 0, device="cpu", seed=0,
                              kind=None if kind == "tokenize" else kind)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            meta = json.loads(resp.read())
        assert meta == {"ok": True, "kind": kind, "model": cfg.model.NAME, "npoints": N_PTS,
                        "num_group": 16, "group_size": 8, "device": "cpu"}
        pts = np.random.default_rng(4).normal(size=(2, N_PTS, 3)).astype(np.float32)
        code, payload = post(base + "/predict", {"points": pts.tolist()})
        model = load_model(cfg, seed=0, device="cpu")
        if kind == "tokenize":
            want = build_tokenize_fn(model, N_PTS)(pts).tolist()
            assert code == 200 and payload == {"tokens": want}
            assert all(isinstance(i, int) for i in payload["tokens"][0])
        else:
            want = build_recon_fn(model, N_PTS)(pts).numpy()
            assert code == 200 and set(payload) == {"recon"}
            np.testing.assert_array_equal(np.asarray(payload["recon"], np.float32), want)
        code, payload = post(base + "/predict", {"points": pts[:, :100].tolist()})
        assert code == 400 and "npoints=128" in payload["error"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_serve_http_kind_needs_a_dvae_config(dvae):
    cfg = dvae[0].copy()
    cfg.model = dict(cfg.model, NAME="PointTransformer")
    with pytest.raises(ValueError, match="Stage-I dVAE"):
        serve_http.serve(cfg, device="cpu", kind="dvae")
    with pytest.raises(ValueError, match="tokenize"):
        serve_http.serve(dvae[0], device="cpu", kind="features")
