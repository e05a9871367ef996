"""Minimal HTTP inference server for the port's classifier, segmentation and
pretrain (features) models.

Stdlib only (http.server), the same contract as ``tools/serve_http.py`` for
the classifier, features and segmentation kinds, but run from a config (or a
task) and an optional reference checkpoint instead of an exported artifact.
A pretrain config (ACT_PointDistillation or ACT_PointBERT) serves the
features kind: the student's cls features, clouds of another point count
than the config's ``npoints`` (else its val split's) resampled by FPS:

  python -m act_tpu_torch.serve_http \
      --config cfgs/finetune_classification/full/finetune_modelnet.yaml \
      [--ckpts model.pth] [--device cuda] --port 8080
  python -m act_tpu_torch.serve_http --config cfgs/pretrain/pretrain_act_distill.yaml \
      [--ckpts ckpt-best.pth] --port 8080                      # features
  python -m act_tpu_torch.serve_http --task partseg|semseg [--npoint 2048] \
      [--num_group 128] [--ckpts model.pth] [--device cuda] --port 8080

  POST /predict   {"points": [[[x,y,z], ...], ...]}   # (B, N, 3)
      -> classifier:   {"logits": [...], "argmax": [...]}
         features:     {"features": [...]}              # (B, cls_dim)
         segmentation: {"labels": [...]}                # (B, N) per-point classes
             (+ "log_probs" with "return_log_probs": true; part segmentation
              also requires "cls_label": (B,) ids or a (B, 16) one-hot)
  GET  /healthz   -> {"ok": true, ...meta}

Malformed requests (wrong shape, non-finite coordinates, a category id
outside [0, 16)) get 400; dispatch to the model is serialized by a lock.
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


def cls_label_one_hot(label, batch: int, n_cat: int) -> np.ndarray:
    """A request's ``cls_label``, (B,) category ids or a (B, n_cat) one-hot,
    as a (B, n_cat) f32 one-hot; ids outside [0, n_cat) and other shapes
    raise ValueError (``tools/serve_http.py:61-82``)."""
    lab = np.asarray(label)
    if lab.ndim == 1:  # category ids -> one-hot
        ids = lab.astype(np.int64)
        if ((ids < 0) | (ids >= n_cat)).any():
            # negatives would silently wrap through fancy indexing
            raise ValueError(f"cls_label ids must be in [0, {n_cat}), "
                             f"got {ids.min()}..{ids.max()}")
        lab = np.eye(n_cat, dtype=np.float32)[ids]
    if lab.shape != (batch, n_cat):
        raise ValueError(f"cls_label must be (B,) ids or (B, {n_cat}) one-hot, "
                         f"got {lab.shape}")
    return lab.astype(np.float32)


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
                extra = ()
                if meta.get("num_categories"):  # part segmentation
                    extra = (cls_label_one_hot(req["cls_label"], pts.shape[0],
                                               int(meta["num_categories"])),)
                with lock:  # one model, serialized dispatch
                    out = fn(pts, *extra).float().cpu().numpy()
            except (ValueError, KeyError, TypeError) as e:  # client errors
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:  # the server keeps running; report it
                traceback.print_exc(file=sys.stderr)
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if meta.get("kind") == "segmentation":
                # per-point labels; the (B, N, C) log-probs only on request
                resp = {"labels": out.argmax(-1).tolist()}
                if req.get("return_log_probs"):
                    resp["log_probs"] = out.tolist()
            elif meta.get("kind") == "features":
                resp = {"features": out.tolist()}
            else:
                resp = {"logits": out.tolist(), "argmax": out.argmax(-1).tolist()}
            self._send(200, resp)

        def log_message(self, fmt, *args):  # quiet default access log
            pass

    return Handler


def make_server(fn: Callable, meta: dict, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    """An HTTP server answering with ``fn`` ((B, N, 3) numpy -> logits
    tensor; for ``meta['kind'] == 'features'`` features; for
    ``'segmentation'`` log-probs, with the (B, 16) one-hot as a second
    argument where ``meta['num_categories']`` is set); port 0 takes a free
    one (``server.server_address[1]``)."""
    return ThreadingHTTPServer((host, port),
                               make_handler(fn, meta, threading.Lock()))


def seg_meta(model, task: str, npoint: int) -> dict:
    """The ``/healthz`` meta of a segmentation server; ``num_categories``
    (part segmentation) makes the handler require a ``cls_label``."""
    from act_tpu_torch.models.segmentation import NUM_SHAPE_CATEGORIES

    meta = {"kind": "segmentation", "task": task, "npoint": int(npoint),
            "cls_dim": int(model.cls_dim), "device": str(next(model.parameters()).device)}
    if model.with_label:
        meta["num_categories"] = NUM_SHAPE_CATEGORIES
    return meta


def serve(config=None, ckpt_path=None, host: str = "127.0.0.1", port: int = 8080,
          device="cuda", seed: int = 0, task=None, npoint: int = 2048,
          num_group: int = 128) -> ThreadingHTTPServer:
    """A server of the classifier of ``config`` (requests resampled to its
    ``npoints`` by FPS); of the features of a pretrain ``config``
    (``build_pretrain_model``: seeded weights or a Stage-II checkpoint;
    ``npoints`` the config's, else its val split's, the SVM probe's); or,
    with ``task`` ('partseg' or 'semseg'), of that segmentation model on
    clouds of exactly ``npoint`` points."""
    from act_tpu_torch.engine.runner_pretrain import TOKENIZERS, build_pretrain_model
    from act_tpu_torch.engine.serve import (build_features_fn, build_infer_fn, load_config,
                                            load_model, load_seg_model)
    from act_tpu_torch.ops import resolve_device

    if task is not None:
        model = load_seg_model(task, ckpt_path, num_group=num_group, seed=seed, device=device)
        return make_server(build_infer_fn(model, int(npoint), with_fps=False),
                           seg_meta(model, task, npoint), host, port)
    cfg = load_config(config)
    if cfg.model.NAME in TOKENIZERS:  # a pretrain model: its features
        dev = resolve_device(device)
        model = build_pretrain_model(cfg.model, seed, ckpt_path).to(dev).eval()
        npoints = int(cfg.get("npoints") or cfg.dataset.val.others.npoints)
        meta = {"kind": "features", "model": cfg.model.NAME, "npoints": npoints,
                "cls_dim": int(cfg.model.transformer_config.cls_dim), "device": str(dev)}
        return make_server(build_features_fn(model, npoints), meta, host, port)
    model = load_model(cfg, ckpt_path, seed=seed, device=device)
    npoints = int(cfg.npoints)
    meta = {"kind": "classifier", "npoints": npoints,
            "cls_dim": int(cfg.model.cls_dim), "device": str(device)}
    return make_server(build_infer_fn(model, npoints), meta, host, port)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None,
                   help="finetune YAML (the classifier) or pretrain YAML (features)")
    p.add_argument("--task", choices=("partseg", "semseg"), default=None,
                   help="serve a segmentation model instead of a classifier")
    p.add_argument("--npoint", type=int, default=2048, help="points a segmentation cloud")
    p.add_argument("--num_group", type=int, default=128)
    p.add_argument("--ckpts", default=None, help="reference .pth (else seeded weights)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args()
    if (args.config is None) == (args.task is None):
        p.error("give one of --config (a classifier) and --task (segmentation)")
    server = serve(args.config, args.ckpts, args.host, args.port, args.device, args.seed,
                   args.task, args.npoint, args.num_group)
    print(f"serving {args.config or args.task} on "
          f"http://{args.host}:{server.server_address[1]}")
    server.serve_forever()


if __name__ == "__main__":
    main()
