from . import buffer, checkpoint
from .self_play import SelfPlayWorker, Trajectory, max_game_length, play_games
from .trainer import (
    AlphaZeroTrainer,
    TrainState,
    apply_eval,
    make_lr_schedule,
    make_optimizer,
    train_step,
)

__all__ = [
    "AlphaZeroTrainer",
    "TrainState",
    "SelfPlayWorker",
    "Trajectory",
    "apply_eval",
    "buffer",
    "checkpoint",
    "make_lr_schedule",
    "make_optimizer",
    "max_game_length",
    "play_games",
    "train_step",
]
