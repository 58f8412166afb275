"""The configuration defaults, without YAML.

A copy of ``DEFAULTS`` from ``othello_reinforcement_learning_test_tpu/
utils/config.py`` (the same sections, keys and values), kept here so that
the port reads no module of the JAX package and needs no pyyaml. Loading a
config file, and the validation that goes with it, come with the port's CLI.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

DEFAULTS: Dict[str, Dict[str, Any]] = {
    "game": {"size": 8, "rules": "reference"},
    "model": {"num_blocks": 10, "num_filters": 128, "board_size": 8},
    "training": {
        "batch_size": 256,
        "lr": 0.001,
        "lr_schedule": "step",
        "lr_step_size": 100,
        "lr_gamma": 0.1,
        "weight_decay": 0.0001,
        "momentum": 0.9,
        "num_iterations": 1000,
        "self_play_episodes_per_iter": 100,
        "train_epochs_per_iter": 10,
        "checkpoint_interval": 10,
        "replay_buffer_size": 100_000,
        "augment_symmetries": False,
        "prioritized_replay": False,
        "gating": {
            "enabled": False,
            "games": 40,
            "win_threshold": 0.55,
            "interval": None,
            "num_simulations": None,
            "opening_random_plies": 4,
        },
    },
    "mcts": {
        "num_simulations": 25,
        "num_simulations_eval": 50,
        "c_puct": 1.0,
        "dirichlet_alpha": 0.3,
        "dirichlet_epsilon": 0.25,
    },
    "self_play": {
        "temperature_threshold": 15,
        "num_parallel_games": None,
        "cond_interval": None,
    },
    "paths": {
        "checkpoint_dir": "data/models",
        "log_dir": "data/logs",
        "data_dir": "data",
    },
    "system": {
        "device": "auto",
        "seed": 42,
        "use_mixed_precision": True,
        "mesh_devices": None,
        "self_play_net_variant": "xla",
        "distributed_self_play": "auto",
        "max_recovery_retries": 3,
    },
}


def load_config() -> Dict:
    """A deep copy of :data:`DEFAULTS`."""
    return copy.deepcopy(DEFAULTS)
