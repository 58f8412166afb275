"""A deterministic stub network written in both frameworks, and helpers
shared by the port's MCTS and self-play tests.

The stub's logits and value are exact in float32 (0/1 features times
multiples of 1/16, and d / (1 + |d|)), so a JAX search and a port search
see the same numbers up to the exp/log/sum of the policy.

JAX is imported inside the functions that need it, so that the port's
multi-process test workers (``torch_mp_worker.py``) take the stub without it.
"""

import numpy as np
import torch

from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import Board


def to_i64(pair) -> np.ndarray:
    a = np.asarray(pair)
    return (a[..., 0].astype(np.uint64) | (a[..., 1].astype(np.uint64) << np.uint64(32))).view(np.int64)


def to_pair(words) -> np.ndarray:
    v = np.asarray(words, dtype=np.int64).view(np.uint64)
    return np.stack([(v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (v >> np.uint64(32)).astype(np.uint32)], axis=-1)


def stub_weights(size, seed=0):
    rng = np.random.default_rng(seed)
    n_in, n_act = size * size * 3, size * size + 1
    return {"W": (rng.integers(-16, 17, (n_in, n_act)) / 16).astype(np.float32),
            "b": (rng.integers(-8, 9, n_act) / 16).astype(np.float32),
            "vw": (rng.integers(-8, 9, n_in) / 64).astype(np.float32),
            "vb": np.float32(0.125)}


def jax_stub(var, x):
    import jax
    import jax.numpy as jnp

    f = x.reshape(x.shape[0], -1)
    d = f @ var["vw"] + var["vb"]
    return jax.nn.log_softmax(f @ var["W"] + var["b"], axis=-1), (d / (1 + jnp.abs(d)))[:, None]


def torch_stub(weights):
    W, b, vw = (torch.from_numpy(weights[k]) for k in ("W", "b", "vw"))
    vb = float(weights["vb"])

    def net(x):
        f = x.reshape(x.shape[0], -1)
        d = f @ vw + vb
        return torch.log_softmax(f @ W + b, dim=-1), (d / (1 + d.abs()))[:, None]

    return net


def random_boards(size, rules, n, plies, seed):
    """Positions after random legal plies (JAX engine), as both layouts."""
    import jax

    from othello_reinforcement_learning_test_tpu.ops import bitboard as jbb

    eng = jbb.get_engine(size, rules)
    rng = np.random.default_rng(seed)
    s = eng.initial_state((n,))
    step = jax.jit(eng.step)
    legal_fn = jax.jit(eng.legal_actions)
    for _ in range(plies):
        legal = np.asarray(legal_fn(s))
        a = np.array([rng.choice(np.flatnonzero(r)) for r in legal], np.int32)
        s, _ = step(s, a)
    tb = Board(torch.from_numpy(to_i64(s.me)), torch.from_numpy(to_i64(s.opp)),
               torch.from_numpy(np.array(s.move_count)), torch.from_numpy(np.array(s.passed)))
    return s, tb
