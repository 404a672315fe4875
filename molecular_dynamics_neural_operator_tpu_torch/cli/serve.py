"""Serving CLI: a TCP rollout service over the continuous-batching server
(``molecular_dynamics_neural_operator_tpu/cli/serve.py``).

Loads a checkpoint, binds a socket and serves concurrent rollout requests:
every connection's request in flight shares the card through
``serving/server.py``'s stream-axis batching.

    python -m molecular_dynamics_neural_operator_tpu_torch.cli.serve \\
        --checkpoint tools/bench_ckpt.npz --max_edges 224 --predict_delta

Protocol: newline-delimited JSON, one request per line per connection
(connections are handled concurrently; several requests on one connection
are answered in order):

    -> {"aa": [R ints], "window": [[[x,y,z] x R] x T], "num_steps": N,
        "id": "optional echo"}
    <- {"id": ..., "coords": [[[x,y,z] x R] x N],
        "final_window": [...], "edge_overflow": false}

Errors come back as {"id": ..., "error": "..."} without killing the
connection. An empty line closes the connection. ``{"op": "stats"}``
returns the server's occupancy counters. Runs on the card unless
``--device cpu`` is given. Every flag of the JAX CLI parses:
``--data_mesh`` > 0 is refused by name before the checkpoint is read
(the parallel modules are not ported), and ``--compilation_cache`` is a
no-op (the port has no compilation cache to point anywhere).
"""

from __future__ import annotations

import argparse
import json
import socketserver
import threading
from pathlib import Path

import numpy as np

from molecular_dynamics_neural_operator_tpu_torch.cli import refuse_unported
from molecular_dynamics_neural_operator_tpu_torch.configs import (
    ModelConfig,
    _from_dict,
)
from molecular_dynamics_neural_operator_tpu_torch.device import resolve_device
from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
from molecular_dynamics_neural_operator_tpu_torch.serving.server import (
    RolloutServer,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    restore_subtree,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", type=Path, default=None,
                   help=".npz checkpoint (TrainState or bare params)")
    p.add_argument("--run_path", type=Path, default=None,
                   help="training run dir: reads config.json and best.npz")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = pick a free port (printed on startup)")
    p.add_argument("--segment_steps", type=int, default=64)
    p.add_argument("--max_streams", type=int, default=8)
    p.add_argument("--threshold", type=float, default=8.0)
    p.add_argument("--clip", type=float, default=None)
    p.add_argument("--impl", choices=["scan", "persistent"], default="scan")
    p.add_argument("--aa_npy", type=Path, default=None,
                   help="(impl=persistent) .npy with the (R,) amino-acid "
                        "sequence the kernels embed; every request must "
                        "send the same one")
    p.add_argument("--max_request_steps", type=int, default=100_000,
                   help="reject requests asking for more steps than this")
    p.add_argument("--data_mesh", type=int, default=0,
                   help="accepted for the JAX CLI's command lines; > 0 is "
                        "refused (the parallel modules are not ported)")
    p.add_argument("--device", default=None,
                   help="cuda (default; a missing card is an error) or cpu")
    # model flags (ignored when --run_path provides config.json)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--kernel_width", type=int, default=1024)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--window_size", type=int, default=10)
    p.add_argument("--num_residues", type=int, default=28)
    p.add_argument("--graph_mode", choices=["dense", "sparse"],
                   default="sparse")
    p.add_argument("--max_edges", type=int, default=384)
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="bfloat16")
    p.add_argument("--predict_delta", action="store_true")
    p.add_argument("--predict_prior", choices=["last", "extrapolate"],
                   default="last")
    p.add_argument("--prior_damping", type=float, default=1.0,
                   help="damping on the extrapolate prior "
                        "(must match training)")
    p.add_argument("--compilation_cache", type=Path, default=None,
                   help="accepted for the JAX CLI's command lines; no-op")
    args = p.parse_args(argv)
    refuse_unported(args)
    return args


def _load(args):
    """Resolve (params, cfg) from --run_path or --checkpoint + flags."""
    device = resolve_device(args.device)
    if args.run_path is not None:
        run_cfg = json.loads((args.run_path / "config.json").read_text())
        cfg = _from_dict(ModelConfig, run_cfg["model"])
        # --checkpoint overrides the run dir's best.npz
        ckpt = args.checkpoint
        if ckpt is None:
            ckpt = args.run_path / "best.npz"
            if not ckpt.exists():
                raise SystemExit(
                    f"{ckpt} does not exist; pass --checkpoint explicitly")
    else:
        cfg = ModelConfig(
            width=args.width, ker_width=args.kernel_width, depth=args.depth,
            window_size=args.window_size, num_residues=args.num_residues,
            graph_mode=args.graph_mode, max_edges=args.max_edges,
            compute_dtype=args.compute_dtype,
            predict_delta=args.predict_delta,
            predict_prior=args.predict_prior,
            prior_damping=args.prior_damping,
        )
        ckpt = args.checkpoint
    template = gkn_init(cfg, seed=0, device=device)
    if ckpt is None:
        print("No checkpoint given: random init (throughput/debug mode)")
        return template, cfg
    params, meta = restore_subtree(ckpt, template, ".params", device=device)
    print(f"Loaded {ckpt} (epoch {meta.get('epoch', '?')})")
    return params, cfg


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        srv = self.server.rollout_server
        max_steps = self.server.max_request_steps
        for raw in self.rfile:
            line = raw.strip()
            if not line:
                return
            rid = None
            try:
                req = json.loads(line)
                rid = req.get("id")
                if req.get("op") == "stats":
                    self._reply({"id": rid, "stats": srv.stats})
                    continue
                n = int(req["num_steps"])
                if n > max_steps:
                    raise ValueError(
                        f"num_steps {n} exceeds --max_request_steps "
                        f"{max_steps}")
                res = srv.rollout(req["aa"], req["window"], n)
                self._reply({
                    "id": rid,
                    "coords": res.coords.tolist(),
                    "final_window": res.final_window.tolist(),
                    "edge_overflow": res.edge_overflow,
                })
            except Exception as e:  # noqa: BLE001: report, keep serving
                self._reply({"id": rid, "error": f"{type(e).__name__}: {e}"})

    def _reply(self, obj) -> None:
        self.wfile.write(json.dumps(obj).encode() + b"\n")
        self.wfile.flush()


class RolloutTCPServer(socketserver.ThreadingTCPServer):
    """One OS thread per connection; all of them feed one RolloutServer,
    so concurrent requests batch onto the stream axis of one segment."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, rollout_server, max_request_steps: int):
        super().__init__(addr, _Handler)
        self.rollout_server = rollout_server
        self.max_request_steps = max_request_steps


def serve(params, cfg, args, *, ready: dict | None = None):
    """Build the batching server and its TCP front and run until
    interrupted. ``ready`` (tests, embedding): before blocking, the dict
    receives ``tcp`` (call ``.shutdown()`` to stop), ``port`` and
    ``event`` (a threading.Event set once the socket is bound)."""
    aa = None
    if args.impl == "persistent":
        if args.aa_npy is None:
            raise SystemExit("--impl persistent requires --aa_npy")
        aa = np.load(args.aa_npy)
    rollout_server = RolloutServer(
        params, cfg,
        segment_steps=args.segment_steps, max_streams=args.max_streams,
        threshold=args.threshold, clip=args.clip, impl=args.impl, aa=aa,
        device=args.device,
    )
    tcp = RolloutTCPServer((args.host, args.port), rollout_server,
                           args.max_request_steps)
    port = tcp.server_address[1]
    print(f"serving on {args.host}:{port} "
          f"(segment_steps={args.segment_steps}, "
          f"max_streams={args.max_streams}, impl={args.impl})", flush=True)
    if ready is not None:
        ready["tcp"] = tcp
        ready["port"] = port
        ready.setdefault("event", threading.Event()).set()
    try:
        tcp.serve_forever(poll_interval=0.1)
    finally:
        tcp.server_close()
        rollout_server.close(drain=False)
    return tcp


def main(argv=None):
    args = parse_args(argv)
    if args.compilation_cache is not None:
        print("NOTE: --compilation_cache has no counterpart in the PyTorch "
              "port; ignoring it")
    params, cfg = _load(args)
    serve(params, cfg, args)


if __name__ == "__main__":
    main()
