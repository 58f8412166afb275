from .mcts import (
    MCTS,
    SearchResult,
    Tree,
    action_evaluations,
    action_probs_from_counts,
    add_dirichlet_noise,
    best_action,
    masked_probs,
    search,
)

__all__ = [
    "MCTS",
    "SearchResult",
    "Tree",
    "action_evaluations",
    "action_probs_from_counts",
    "add_dirichlet_noise",
    "best_action",
    "masked_probs",
    "search",
]
