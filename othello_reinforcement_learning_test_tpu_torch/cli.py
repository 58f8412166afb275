"""Command-line interface: ``train`` / ``eval`` / ``play`` / ``export``.

Port of ``othello_reinforcement_learning_test_tpu/cli.py``, with the same
subcommands, flags, defaults and choices::

    python -m othello_reinforcement_learning_test_tpu_torch.cli train --config configs/test.yaml
    python -m othello_reinforcement_learning_test_tpu_torch.cli eval --checkpoint data/models/final_model.pt
    python -m othello_reinforcement_learning_test_tpu_torch.cli play --checkpoint data/models/final_model.pt
    python -m othello_reinforcement_learning_test_tpu_torch.cli export --checkpoint ... --out ... --format torchscript

Differences from the JAX CLI:

- devices: ``--device auto`` (and ``system.device: "auto"`` in a config)
  means CUDA, ``cpu`` the CPU. Nothing probes the card or falls back to the
  CPU: without CUDA, ``auto`` raises;
- ``train --coordinator host:port --num-processes N --process-id i`` (or
  ``$OTHELLO_COORDINATOR``, ``$OTHELLO_NUM_PROCESSES``,
  ``$OTHELLO_PROCESS_ID``) joins a ``torch.distributed`` process group, one
  process a device: NCCL on CUDA (one card a rank), gloo on the CPU. Under
  torchrun (``torchrun --nproc-per-node N -m
  othello_reinforcement_learning_test_tpu_torch.cli train ...``) its
  environment does the same. As in the JAX CLI, ``--num-processes`` and
  ``--process-id`` without a coordinator are ignored;
- checkpoints are the port's ``.pt`` files (``train/checkpoint.py``) or
  reference-format ``.pt`` files; the JAX package's orbax directories need
  JAX and are not read;
- ``export --format stablehlo`` writes the port's serving program, a
  ``torch.export`` program (``models/export.py``), in place of StableHLO.
  ``export`` runs on the CPU, as the JAX command does: it is weight
  surgery and tracing, and its files load on any device.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from .utils.device import resolve_device


def set_seed(seed: int) -> torch.Generator:
    """Seed ``random`` and numpy, and return a CPU generator seeded with
    ``seed`` that the command draws its match seeds from."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def draw_seed(gen: torch.Generator) -> int:
    """The next match seed from a command's generator."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen))


def train_command(args) -> None:
    from .train import checkpoint as ckpt_lib
    from .train.trainer import AlphaZeroTrainer
    from .utils.config import load_config

    config = load_config(args.config)
    device = config.get("system", {}).get("device", "auto")

    # multi-process bring-up (flag, environment or torchrun) before the
    # trainer: every process runs this command with its own --process-id
    coordinator = args.coordinator or os.environ.get("OTHELLO_COORDINATOR")
    torchrun = int(os.environ.get("WORLD_SIZE", 1)) > 1 and "MASTER_ADDR" in os.environ
    if coordinator or torchrun:
        from .parallel import mesh

        if coordinator:
            num_processes = args.num_processes or int(os.environ.get("OTHELLO_NUM_PROCESSES", 0))
            process_id = (args.process_id if args.process_id is not None
                          else int(os.environ.get("OTHELLO_PROCESS_ID", -1)))
            if num_processes <= 0 or process_id < 0:
                raise SystemExit("--coordinator requires --num-processes and --process-id "
                                 "(or OTHELLO_NUM_PROCESSES / OTHELLO_PROCESS_ID)")
            mesh.initialize_distributed(coordinator, num_processes, process_id, device=device)
        else:
            mesh.initialize_distributed(device=device)
        print(f"distributed: process {mesh.process_index()}/{mesh.process_count()} up, "
              f"{mesh.process_count()} global devices")

    print("=" * 70)
    print("AlphaZero Training (PyTorch/CUDA)")
    print("=" * 70)
    print(f"config: {args.config}")

    trainer = AlphaZeroTrainer(config)
    if trainer.device.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(trainer.device)}")
    if args.resume:
        path = args.resume
        if path == "latest":
            path = ckpt_lib.latest_checkpoint(trainer.checkpoint_dir)
            if path is None:
                raise SystemExit("--resume latest: no checkpoint found")
        trainer.load_checkpoint(path)
    t0 = time.time()
    try:
        trainer.train()
    finally:
        trainer.close()
    print(f"training done in {time.time() - t0:.1f}s")


def eval_command(args) -> None:
    from .evaluation import GreedyPlayer, MCTSPlayer, RandomPlayer, evaluate_player

    device = resolve_device(args.device)
    if args.simulations is None:
        # honor mcts.num_simulations_eval from the checkpoint's config sidecar
        from .train.checkpoint import load_config as _ckpt_config

        cfg = _ckpt_config(args.checkpoint) or {}
        args.simulations = int(cfg.get("mcts", {}).get("num_simulations_eval") or 50)

    print("=" * 70)
    print("Model Evaluation")
    print("=" * 70)
    print(f"checkpoint: {args.checkpoint}")
    print(f"games per opponent: {args.games}; simulations: {args.simulations}")

    try:
        player = MCTSPlayer.from_checkpoint(args.checkpoint, num_simulations=args.simulations,
                                            device=device)
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}") from None
    engine = player.engine
    rng = set_seed(args.seed)

    opponents = [RandomPlayer(engine), GreedyPlayer(engine)]
    if args.minimax_depth:
        # strong classical anchor (C++ alpha-beta; needs a compiler + 8x8)
        try:
            from .evaluation import NativeMinimaxPlayer

            opponents.append(NativeMinimaxPlayer(engine, depth=args.minimax_depth))
        except Exception as e:  # noqa: BLE001 — no compiler / non-8x8
            print(f"minimax opponent unavailable: {e}")
    if args.edax:
        from .evaluation import EdaxPlayer

        binary = None if args.edax == "auto" else args.edax
        edax = EdaxPlayer(engine, binary_path=binary, level=args.edax_level,
                          args=args.edax_args)
        if edax.binary is None:
            print("edax binary not found ($EDAX_BINARY / PATH); skipping")
        else:
            opponents.append(edax)
    results_summary = {}
    for opponent in opponents:
        seed = draw_seed(rng)
        try:
            out = evaluate_player(player, opponent, engine, num_games=args.games, seed=seed,
                                  verbose=args.verbose,
                                  opening_random_plies=args.opening_random_plies,
                                  device=device)
        except Exception as e:  # noqa: BLE001 — keep the other opponents' results
            print(f"vs {opponent.name}: evaluation failed ({e})")
            results_summary[opponent.name] = {"error": str(e)}
            continue
        results_summary[opponent.name] = {
            "win_rate": out["win_rate"],
            "avg_score": out["avg_score"],
            "avg_moves": out["avg_moves"],
            "wins": out["wins"],
            "losses": out["losses"],
            "draws": out["draws"],
        }
        print(
            f"vs {opponent.name:8s}: {out['win_rate'] * 100:5.1f}% win rate "
            f"({out['wins']}W-{out['losses']}L-{out['draws']}D), "
            f"avg score {out['avg_score']:.1f}, avg moves {out['avg_moves']:.1f}"
        )

    if args.save_results:
        out_dir = "data/eval"
        os.makedirs(out_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        path = os.path.join(out_dir, f"eval_{stamp}.json")
        with open(path, "w") as f:
            json.dump(
                {
                    "checkpoint": args.checkpoint,
                    "timestamp": datetime.now().isoformat(),
                    "mcts_simulations": args.simulations,
                    "games_per_opponent": args.games,
                    "results": results_summary,
                },
                f,
                indent=2,
            )
        print(f"results saved to {path}")


def play_command(args) -> None:
    """Human vs AI in the terminal; moves are read with ``input``."""
    from .evaluation import HumanPlayer, MCTSPlayer
    from .ops.bitboard import Board

    device = resolve_device(args.device)
    try:
        player_ai = MCTSPlayer.from_checkpoint(args.checkpoint, num_simulations=args.simulations,
                                               device=device)
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}") from None
    engine = player_ai.engine
    human = HumanPlayer(engine, input_fn=input)
    rng = set_seed(args.seed)
    gen = torch.Generator(device=device).manual_seed(draw_seed(rng))

    def single(b: Board) -> Board:
        return Board(*(t[0] for t in b))

    human_is_black = args.color != "white"
    boards = engine.initial_state((1,), device=device)
    print("you are", "black ●" if human_is_black else "white ○")
    while not bool(engine.is_terminal(boards)[0]):
        mover_black = int(boards.move_count[0]) % 2 == 0
        print()
        print(engine.to_string(single(boards)))
        c_me, c_opp = engine.stone_counts(boards)
        black = int(c_me[0]) if mover_black else int(c_opp[0])
        white = int(c_opp[0]) if mover_black else int(c_me[0])
        print(f"● {black} - ○ {white}   ({'●' if mover_black else '○'} to move)")
        if mover_black == human_is_black:
            action = human.act(boards, gen)
        else:
            action = player_ai.act(boards, gen)
            a = int(action[0])
            if a == engine.pass_action:
                print("AI passes")
            else:
                print(f"AI plays {a} ({a // engine.size},{a % engine.size})")
        boards, ok = engine.step(boards, action)
        if not bool(ok[0]):
            print("(move rejected)")
    print()
    print(engine.to_string(single(boards)))
    mover_black = int(boards.move_count[0]) % 2 == 0
    w = int(engine.winner(boards)[0])
    w_black = w if mover_black else -w
    outcome = "draw" if w_black == 0 else ("black ● wins" if w_black > 0 else "white ○ wins")
    print(f"game over: {outcome}")


def export_command(args) -> None:
    """Export a checkpoint to interchange formats:

    - ``reference-pt``: a torch checkpoint with the reference trainer's dict
      shape and state-dict keys, loadable by the reference's tools;
    - ``torchscript``: a traced module, the reference's NCHW I/O;
    - ``onnx``: needs the optional ``onnx`` package (raises without it);
    - ``stablehlo``: the port's serving program, ``torch.export``
      (``models/export.py``), NHWC in as the JAX export.

    The input may be a port checkpoint or a reference ``.pt`` file, so this
    also converts reference checkpoints between formats.

    The one entry point that runs on the CPU with no ``cpu`` asked for: it
    is weight surgery and tracing, not work on the hot path, and the JAX
    command forces the CPU too. Every file it writes holds CPU tensors;
    ``models/export.py::load_exported`` moves the ``stablehlo`` program to
    the card, and ``torch.jit.load(..., map_location=...)`` does so for
    TorchScript.
    """
    from .evaluation.players import MCTSPlayer
    from .train import checkpoint as ckpt_lib

    player = MCTSPlayer.from_checkpoint(args.checkpoint, device="cpu")
    state_dict = player.model.state_dict()
    if args.format == "reference-pt":
        from .models.torch_bridge import save_reference_checkpoint

        cfg = player.config or ckpt_lib.load_config(args.checkpoint) or {}
        save_reference_checkpoint(state_dict, args.out, config=cfg)
    elif args.format == "torchscript":
        from .models.torch_bridge import save_torchscript

        save_torchscript(state_dict, args.out, batch_size=args.batch_size)
    elif args.format == "onnx":
        from .models.torch_bridge import save_onnx

        save_onnx(state_dict, args.out, batch_size=args.batch_size)
    else:  # stablehlo: the torch.export program
        from .models.export import save_exported

        save_exported(player.model, args.out, batch_size=args.batch_size)
    print(f"exported {args.format} -> {args.out}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Othello AlphaZero (PyTorch/CUDA) - CLI")
    sub = parser.add_subparsers(dest="command", help="Commands")

    p_train = sub.add_parser("train", help="Train the model")
    p_train.add_argument("--config", type=str, default="configs/default_8x8.yaml")
    p_train.add_argument(
        "--resume", type=str, default=None,
        help="checkpoint path or 'latest' to resume training",
    )
    p_train.add_argument(
        "--coordinator", type=str, default=None,
        help="multi-process: coordinator address host:port "
             "(or $OTHELLO_COORDINATOR); run one process per device",
    )
    p_train.add_argument("--num-processes", type=int, default=None)
    p_train.add_argument("--process-id", type=int, default=None)
    p_train.set_defaults(func=train_command)

    p_eval = sub.add_parser("eval", help="Evaluate the model")
    p_eval.add_argument("--checkpoint", type=str, required=True)
    p_eval.add_argument("--games", type=int, default=20)
    p_eval.add_argument("--simulations", type=int, default=None,
                        help="MCTS simulations per move (default: the checkpoint config "
                             "mcts.num_simulations_eval, else 50)")
    p_eval.add_argument("--seed", type=int, default=42)
    p_eval.add_argument("--minimax-depth", type=int, default=0,
                        help="also evaluate vs the native C++ alpha-beta "
                             "anchor at this depth (0 = off)")
    p_eval.add_argument("--edax", nargs="?", const="auto", default=None,
                        metavar="BINARY",
                        help="add an Edax opponent; optional binary path "
                             "(default: $EDAX_BINARY or 'edax' on PATH)")
    p_eval.add_argument("--edax-level", type=int, default=5)
    p_eval.add_argument("--edax-args", type=str, default=None,
                        help="override the engine argv (shlex-split), e.g. "
                             "'-q --level 21 -book-usage off'")
    p_eval.add_argument("--opening-random-plies", type=int, default=0,
                        help="randomize the first k plies (game diversity "
                             "between deterministic players)")
    p_eval.add_argument("--device", choices=["auto", "cpu"], default="auto",
                        help="auto = CUDA (required); cpu = the CPU")
    p_eval.add_argument("--verbose", action="store_true")
    p_eval.add_argument("--save-results", action="store_true")
    p_eval.set_defaults(func=eval_command)

    p_play = sub.add_parser("play", help="Play against AI")
    p_play.add_argument("--checkpoint", type=str, required=True)
    p_play.add_argument("--simulations", type=int, default=100)
    p_play.add_argument("--color", choices=["black", "white"], default="black")
    p_play.add_argument("--seed", type=int, default=0)
    p_play.add_argument("--device", choices=["auto", "cpu"], default="auto",
                        help="auto = CUDA (required); cpu = the CPU")
    p_play.set_defaults(func=play_command)

    p_exp = sub.add_parser(
        "export",
        help="Export a checkpoint (reference .pt / TorchScript / ONNX / torch.export); "
             "runs on the CPU, as the JAX export does",
    )
    p_exp.add_argument("--checkpoint", type=str, required=True,
                       help="a port .pt checkpoint or a reference .pt file")
    p_exp.add_argument("--out", type=str, required=True)
    p_exp.add_argument(
        "--format",
        choices=["reference-pt", "torchscript", "onnx", "stablehlo"],
        default="reference-pt",
        help="stablehlo writes the port's torch.export program (torch.export.save), "
             "its counterpart of the JAX StableHLO export",
    )
    p_exp.add_argument("--batch-size", type=int, default=1,
                       help="static batch for torchscript/onnx/stablehlo")
    p_exp.set_defaults(func=export_command)

    return parser


def main(argv: Optional[list] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if hasattr(args, "func"):
        args.func(args)
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
