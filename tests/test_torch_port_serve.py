"""The port's HTTP server on the CPU: one good request, malformed ones, health."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from act_tpu_torch import serve_http
from act_tpu_torch.engine.serve import build_infer_fn, load_model
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

NPOINTS = 128
MODEL = dict(NAME="PointTransformer", embed_dim=48, depth=2, cls_dim=10,
             num_heads=3, group_size=8, num_group=16, encoder_dims=48,
             transfer_type="mlp-3", dtype="bf16")


@pytest.fixture(scope="module")
def server():
    cfg = ConfigDict(dict(npoints=NPOINTS, model=MODEL))
    srv = serve_http.serve(cfg, host="127.0.0.1", port=0, device="cpu", seed=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)
    assert not th.is_alive()


def request(srv, path, payload=None):
    url = f"http://127.0.0.1:{srv.server_address[1]}{path}"
    data = None if payload is None else (
        payload if isinstance(payload, bytes) else json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_predict_matches_direct_call(server, rng):
    pts = rng.normal(size=(2, 300, 3)).astype(np.float32)
    code, resp = request(server, "/predict", {"points": pts.tolist()})
    assert code == 200
    model = load_model(ConfigDict(dict(npoints=NPOINTS, model=MODEL)), seed=0,
                       device="cpu")
    want = build_infer_fn(model, NPOINTS)(pts)
    np.testing.assert_allclose(np.asarray(resp["logits"]), want.numpy(), rtol=1e-6, atol=1e-6)
    assert resp["argmax"] == want.argmax(-1).tolist()


@pytest.mark.parametrize("payload", [
    {"points": [[1.0, 2.0, 3.0]]},            # not (B, N, 3)
    {"pts": [[[1.0, 2.0, 3.0]]]},             # no points key
    {"points": [[[0.0, 0.0, 0.0]] * 8]},      # fewer points than npoints
    b"{not json",
    {"points": [[[float("nan"), 0.0, 0.0]] + [[0.0, 0.0, 1.0]] * 200]},  # NaN
])
def test_malformed_request_is_400(server, payload):
    code, resp = request(server, "/predict", payload)
    assert code == 400 and "error" in resp


def test_healthz_and_unknown_path(server):
    code, resp = request(server, "/healthz")
    assert code == 200 and resp["ok"] and resp["kind"] == "classifier"
    assert resp["npoints"] == NPOINTS and resp["cls_dim"] == 10
    assert request(server, "/nope")[0] == 404


def test_server_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_http.serve(ConfigDict(dict(npoints=NPOINTS, model=MODEL)), port=0)
