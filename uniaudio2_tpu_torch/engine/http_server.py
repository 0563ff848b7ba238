"""HTTP serving endpoint over the dynamic batcher, stdlib only (port of
`uniaudio2_tpu/engine/http_server.py`).

A `ThreadingHTTPServer` whose request threads submit into a
`BatchingServer` (`engine/server.py`) and block on the future, so
concurrent HTTP requests ride one batched decode. The request threads
handle host data only (JSON, numpy grids); the batcher's worker is the one
thread that runs the engine on the device.

Endpoints (JSON in/out):

  GET  /healthz     -> {"ok": true, "stats": {...}}
  POST /v1/tts      -> two-phase audio decode.
        {"text_tokens": [...], "prompt_tokens": [...],
         "temperature"?: f, "topk"?: i, "seed"?: i}
        -> {"reason": [[8 x T1]], "semantic": [[8 x T2]]}
  POST /v1/asr      -> text decode from audio tokens.
        {"reason": [[8 x T1]], "semantic": [[8 x T2]],
         "prompt_tokens": [...], ...sampling}
        -> {"tokens": [...]}

A token-level API by design: task grids are built with `engine/tasks.py`
as the CLI builds them, so the endpoint needs no tokenizer or codec assets
(text tokenization and codec encode/decode are separate stages, as in the
reference CLI's stage split, `multi_task_inference.py:558`). A deployment
wanting raw text / wav I/O wraps this with the tokenizer and codec facades
(`cli.py` shows the wiring).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from uniaudio2_tpu_torch.engine import tasks
from uniaudio2_tpu_torch.engine.server import BatchingServer


class _Handler(BaseHTTPRequestHandler):
    server_version = "uniaudio2-torch/0.1"

    # quiet default request logging (production servers log upstream)
    def log_message(self, fmt, *args):
        pass

    def _json(self, code: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._json(200, {"ok": True, "stats": self.server.batcher.stats})
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return self._json(400, {"error": "invalid JSON"})
        try:
            if self.path == "/v1/tts":
                return self._tts(req)
            if self.path == "/v1/asr":
                return self._asr(req)
            return self._json(404, {"error": "not found"})
        except (KeyError, ValueError, AssertionError) as e:
            return self._json(400, {"error": str(e)})
        except Exception as e:  # a decode failure
            return self._json(500, {"error": str(e)})

    def _sampling(self, req, default_topk):
        return dict(
            temperature=float(req.get("temperature", 0.9)),
            topk=int(req.get("topk", default_topk)),
            seed=int(req.get("seed", 888)),
        )

    def _tts(self, req):
        ts = self.server.token_space
        grid, mask = tasks.prepare_tts(
            np.asarray(req.get("prompt_tokens", []), np.int64),
            np.asarray(req["text_tokens"], np.int64),
            ts,
        )
        fut = self.server.batcher.submit(
            "audio", grid, mask, **self._sampling(req, 200))
        reason, semantic = fut.result(timeout=self.server.timeout_s)
        self._json(200, {"reason": np.asarray(reason).tolist(),
                         "semantic": np.asarray(semantic).tolist()})

    def _asr(self, req):
        ts = self.server.token_space
        # reason/semantic arrive codebook-major (8, T), the reference's
        # artifact convention (and what /v1/tts returns); `tasks.prepare_asr`
        # wants frame-major (T, 8), as the CLI builds it
        reason = np.asarray(req["reason"], np.int64)
        semantic = np.asarray(req["semantic"], np.int64)
        ncb = ts.num_codebooks
        if reason.ndim != 2 or semantic.ndim != 2:
            raise ValueError("reason/semantic must be 2-D (8, T)")
        if reason.shape[0] != ncb or semantic.shape[0] != ncb:
            raise ValueError(f"expected {ncb} codebook rows")
        grid, mask = tasks.prepare_asr(
            np.asarray(req.get("prompt_tokens", []), np.int64),
            reason.T, semantic.T, ts,
        )
        fut = self.server.batcher.submit(
            "text", grid, mask, **self._sampling(req, 1))
        toks = fut.result(timeout=self.server.timeout_s)
        self._json(200, {"tokens": np.asarray(toks).tolist()})


class InferenceHTTPServer(ThreadingHTTPServer):
    """HTTP front end bound to a DecodeEngine via a BatchingServer."""

    daemon_threads = True

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 *, max_batch: int = 8, max_wait_ms: float = 5.0,
                 timeout_s: float = 600.0):
        super().__init__((host, port), _Handler)
        self.engine = engine
        self.token_space = engine.cfg.tokens
        self.timeout_s = timeout_s
        self.batcher = BatchingServer(
            engine, max_batch=max_batch, max_wait_ms=max_wait_ms)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> "InferenceHTTPServer":
        self.batcher.start()
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self.batcher.stop()
        self.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def main(argv=None):
    """CLI: serve a (converted) checkpoint.

    python -m uniaudio2_tpu_torch.engine.http_server --npz model.npz \
        --train_config config.yaml --port 8000 [--quantize int4all] \
        [--device cpu]
    """
    import argparse

    import torch
    import yaml

    from uniaudio2_tpu_torch.cli import resolve_device
    from uniaudio2_tpu_torch.config import UnifiedModelConfig
    from uniaudio2_tpu_torch.convert.torch_ckpt import load_npz, to_port
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine
    from uniaudio2_tpu_torch.models import unified
    from uniaudio2_tpu_torch.ops.quant import quantize_unified_params

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--npz", required=True)
    p.add_argument("--train_config", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--max_frames", type=int, default=500)
    p.add_argument("--quantize", default="int8",
                   choices=["0", "int8", "int4", "int4all", "int4allg"])
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to serve on (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    with open(args.train_config) as f:
        cfg = UnifiedModelConfig.from_train_yaml(yaml.safe_load(f))
    like = unified.init_params(cfg, torch.Generator(), dtype=torch.bfloat16,
                               device="meta")
    params = to_port(load_npz(args.npz, like), None, device)   # as stored
    if args.quantize != "0":
        if args.quantize in ("int4all", "int4allg"):
            int4 = ("backbone", "decoder", "understanding_expert",
                    "generation_expert", "audio_head", "projection_w")
        elif args.quantize == "int4":
            int4 = ("decoder", "audio_head", "projection_w")
        else:
            int4 = ()
        with torch.no_grad():
            params = unified.prepare_serving_params(quantize_unified_params(
                params, int4_modules=int4,
                grouped=args.quantize.endswith("g")))
    engine = DecodeEngine(params, cfg, max_frames=args.max_frames)
    srv = InferenceHTTPServer(
        engine, args.host, args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    print(f"serving on http://{args.host}:{srv.port}")
    srv.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
