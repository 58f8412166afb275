"""Web app entry point: serves the canvas client and the REST API.

    python -m othello_reinforcement_learning_test_tpu_torch.run_web [--device cpu] [--model m.pt]

Port of the root ``run_web.py`` (which stays JAX-only), with its flags and
defaults. ``--device auto`` is CUDA and raises without it: no health check,
no fall back to the CPU; ``--device cpu`` must be asked for. The stdlib
threading HTTP server is the default; ``--asgi`` runs the FastAPI adapter
under uvicorn, which both must be installed for.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .apps.web.game_manager import GameManager
from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Othello AlphaZero web app")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--model", default=None, help="checkpoint (.pt) to preload")
    parser.add_argument("--model-dir", default="data/models")
    parser.add_argument("--simulations", type=int, default=100)
    parser.add_argument("--asgi", action="store_true",
                        help="serve via FastAPI/uvicorn if installed")
    parser.add_argument("--device", choices=["auto", "cpu"], default="auto",
                        help="auto: CUDA (required)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    gm = GameManager(model_dir=args.model_dir, device=resolve_device(args.device))
    gm.set_simulations(args.simulations)
    if args.model:
        ok, err = gm.load_model(args.model)
        print(f"model preload: {'ok' if ok else f'failed: {err}'}")

    if args.asgi:
        import uvicorn

        from .apps.web.api import create_app

        uvicorn.run(create_app(gm), host=args.host, port=args.port)
        return

    from .apps.web.server import make_server

    server, _ = make_server(args.host, args.port, gm=gm)
    print(f"serving on http://{args.host}:{args.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
