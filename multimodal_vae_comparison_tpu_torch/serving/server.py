"""Minimal HTTP inference server over the InferenceEngine (counterpart of
``serving/server.py``).

Stdlib-only: POST /generate with a JSON body
``{"inputs": {"mod_1": {"data": [...]}}, "seed": 0}`` returns JSON
reconstructions for every modality; GET /health returns model metadata.

    python -m multimodal_vae_comparison_tpu_torch.serving.server \
        --model results/<exp>/version_0 --port 8500

serves a run directory the port's Trainer wrote (its ``model/last``
checkpoint, through ``eval/infer.py``) on the card; ``--device cpu`` serves
it on the CPU.  :func:`serve` takes an engine built in Python.
"""
from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def make_handler(engine, infer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {
                    "status": "ok",
                    "model": type(infer.model).__name__,
                    "modalities": list(infer.mod_names),
                    "n_latents": infer.model.n_latents,
                })
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                inputs = {}
                for name, mod in req["inputs"].items():
                    entry = {"data": np.asarray(mod["data"], np.float32)}
                    if mod.get("masks") is not None:
                        entry["masks"] = np.asarray(mod["masks"], bool)
                    inputs[name] = entry
                out = engine.generate(inputs, seed=int(req.get("seed", 0)))
                self._send(200, {k: v.tolist() for k, v in out.items()})
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                # malformed request (bad json, unknown modality, shape
                # disagreement: the engine's own input validation)
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                # anything else is a server-side failure, not client error
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(engine, infer, port: int = 8500, host: str = "127.0.0.1"):
    """Serve ``engine`` over HTTP until interrupted."""
    server = ThreadingHTTPServer((host, port), make_handler(engine, infer))
    print(f"serving {type(infer.model).__name__} on http://{host}:{port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv=None) -> None:
    from multimodal_vae_comparison_tpu_torch.device import set_numerics
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    from multimodal_vae_comparison_tpu_torch.serving.engine import InferenceEngine
    set_numerics()
    parser = argparse.ArgumentParser(description="serve a trained run directory")
    parser.add_argument("--model", required=True, help="run dir (results/<exp>/version_N)")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    infer = MultimodalVAEInfer(args.model, device=args.device)
    print(f"restored {infer.ckpt_path}")
    serve(InferenceEngine(infer, device=infer.device), infer, args.port)


if __name__ == "__main__":
    main()
