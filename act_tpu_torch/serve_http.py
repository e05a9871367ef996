"""Minimal HTTP inference server for the port's classifier.

Stdlib only (http.server), the same contract as ``tools/serve_http.py`` for
the classifier kind, but run from a config and an optional reference
checkpoint instead of an exported artifact:

  python -m act_tpu_torch.serve_http \
      --config cfgs/finetune_classification/full/finetune_modelnet.yaml \
      [--ckpts model.pth] [--device cuda] --port 8080

  POST /predict   {"points": [[[x,y,z], ...], ...]}   # (B, N, 3)
      -> {"logits": [...], "argmax": [...]}
  GET  /healthz   -> {"ok": true, ...meta}

Malformed requests (wrong shape, non-finite coordinates) get 400; dispatch
to the model is serialized by a lock.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np


def make_handler(fn: Callable, meta: dict, lock: threading.Lock):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, **meta})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                pts = np.asarray(req["points"], np.float32)
                if pts.ndim != 3 or pts.shape[-1] != 3:
                    raise ValueError(f"points must be (B, N, 3), got {pts.shape}")
                if not np.isfinite(pts).all():
                    raise ValueError("points must be finite (no NaN or inf)")
                with lock:  # one model, serialized dispatch
                    out = fn(pts).float().cpu().numpy()
            except (ValueError, KeyError, TypeError) as e:  # client errors
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:  # the server keeps running; report it
                traceback.print_exc(file=sys.stderr)
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {"logits": out.tolist(),
                             "argmax": out.argmax(-1).tolist()})

        def log_message(self, fmt, *args):  # quiet default access log
            pass

    return Handler


def make_server(fn: Callable, meta: dict, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    """An HTTP server answering with ``fn`` ((B, N, 3) numpy -> logits
    tensor); port 0 takes a free one (``server.server_address[1]``)."""
    return ThreadingHTTPServer((host, port),
                               make_handler(fn, meta, threading.Lock()))


def serve(config, ckpt_path=None, host: str = "127.0.0.1", port: int = 8080,
          device="cuda", seed: int = 0) -> ThreadingHTTPServer:
    from act_tpu_torch.engine.serve import build_infer_fn, load_config, load_model

    cfg = load_config(config)
    model = load_model(cfg, ckpt_path, seed=seed, device=device)
    npoints = int(cfg.npoints)
    meta = {"kind": "classifier", "npoints": npoints,
            "cls_dim": int(cfg.model.cls_dim), "device": str(device)}
    return make_server(build_infer_fn(model, npoints), meta, host, port)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="finetune YAML")
    p.add_argument("--ckpts", default=None, help="reference .pth (else seeded weights)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args()
    server = serve(args.config, args.ckpts, args.host, args.port, args.device,
                   args.seed)
    print(f"serving {args.config} on http://{args.host}:{server.server_address[1]}")
    server.serve_forever()


if __name__ == "__main__":
    main()
