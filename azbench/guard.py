"""The check that nothing the benchmark runs loads JAX or the JAX package.

Module names are compared by their top-level name (the part before the
first dot) whole: the port's package name begins with the JAX package's.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "othello_reinforcement_learning_test_tpu")


def forbidden(names: Iterable[str]) -> List[str]:
    """The top-level names among ``names`` that are forbidden, sorted."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def loaded(modules) -> List[str]:
    """The forbidden packages among loaded ``modules`` (``sys.modules``)."""
    return forbidden(list(modules))


def imported_by(path: Path) -> List[str]:
    """Every absolute module name a Python source imports."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names
