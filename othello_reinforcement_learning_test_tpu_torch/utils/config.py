"""Config loading with validation, and a reader for the YAML the configs use.

Port of ``othello_reinforcement_learning_test_tpu/utils/config.py``:
``DEFAULTS`` (the same sections, keys and values), :func:`load_config`
(the same merge over the defaults, nested blocks such as
``training.gating`` included, the same warnings for unknown sections and
keys, ``model.board_size`` taken from ``game.size`` unless the file sets
it) and :func:`_validate` (the same errors and messages).

The JAX package reads files with pyyaml, which the port does not need: it
reads them with :func:`parse_yaml`, one code path on every machine. The
reader takes the subset that ``configs/*.yaml`` is written in:

- comments (``#`` at the start of a line or after a blank), blank lines;
- block mappings, nested by indentation with spaces;
- keys that are identifiers (letters, digits, ``_``, ``-``, ``.``; not
  starting with a digit);
- scalars: ``null``, ``~`` or nothing; ``true`` / ``false``; integers
  (``42``, ``-3``); floats (``0.001``, ``.5``, ``1e-4``, ``2.5E+3``);
  single- or double-quoted strings on one line, without backslash
  escapes; other plain text as a string.

Anything outside it raises :class:`YAMLSubsetError` naming the line:
sequences, flow collections (``[...]``, ``{...}``), block scalars (``|``,
``>``), anchors, aliases, tags, directives and document markers, tabs,
quoted keys, backslash escapes, duplicate keys, and plain scalars that
YAML 1.1 (pyyaml) and YAML 1.2 read differently (``yes``/``no``/``on``/
``off``, ``0x1F``, ``017``, ``1_000``, ``1:30``, ``.inf``, dates). One deliberate difference from pyyaml, which
follows YAML 1.1: a number with an exponent but no dot, or no sign in the
exponent (``1e-4``, ``1.0e5``), is a float here, as in YAML 1.2, where
pyyaml reads it as a string.
"""

from __future__ import annotations

import copy
import re
import warnings
from typing import Any, Dict, List, Optional, Tuple

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


class YAMLSubsetError(ValueError):
    """The text uses YAML outside the subset :func:`parse_yaml` reads."""


_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*")
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?|[-+]?[0-9]+[eE][-+]?[0-9]+")
_NULL = ("", "~", "null", "Null", "NULL")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
# plain scalars that YAML 1.1 (pyyaml) and YAML 1.2 read differently
_AMBIGUOUS = (re.compile(r"(?i)(yes|no|on|off)"),
              re.compile(r"[-+]?0[0-9_]+"),                  # 017: octal in 1.1
              re.compile(r"[-+]?0[xXoObB][0-9A-Fa-f_]+"),
              re.compile(r"[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?"),  # 1:30
              re.compile(r"[-+]?\.?[0-9][0-9._]*_[0-9._]*([eE][-+]?[0-9]+)?"),  # 1_000
              re.compile(r"[-+]?\.(inf|Inf|INF|nan|NaN|NAN)"),
              re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}([Tt ].*)?"))  # dates


def _fail(lineno: int, what: str) -> YAMLSubsetError:
    return YAMLSubsetError(f"line {lineno}: {what} is outside the YAML subset this "
                           "reader takes (block mappings of scalars)")


def _quoted(text: str, lineno: int) -> Tuple[str, str]:
    """A quoted scalar at the start of ``text`` -> (value, rest of line)."""
    q, out, i = text[0], [], 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":  # '' is one quote
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        if q == '"' and ch == "\\":
            raise _fail(lineno, "a backslash escape")
        out.append(ch)
        i += 1
    raise _fail(lineno, "a quoted scalar that does not end on its line")


def _after_quote(rest: str, lineno: int) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise _fail(lineno, f"text after a quoted scalar ({rest!r})")


def _strip_comment(text: str) -> str:
    """Plain text up to a comment (``#`` at the start or after a blank)."""
    m = re.search(r"(^|\s)#", text)
    return (text[:m.start()] if m else text).strip()


def _scalar(text: str, lineno: int) -> Any:
    """A value's text (after ``key:``) -> its Python value."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, lineno)
        _after_quote(rest, lineno)
        return value
    text = _strip_comment(text)
    if text[:1] in ("[", "{"):
        raise _fail(lineno, "a flow collection")
    if text[:1] in ("|", ">"):
        raise _fail(lineno, "a block scalar")
    if text[:1] in ("&", "*", "!", "%", "@", "`", "?") or text == "-" or text[:2] == "- ":
        raise _fail(lineno, f"the plain scalar {text!r}")
    if ": " in text or text.endswith(":"):
        raise _fail(lineno, f"a mapping inside a plain scalar ({text!r})")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    for pattern in _AMBIGUOUS:
        if pattern.fullmatch(text):
            raise _fail(lineno, f"the plain scalar {text!r} (YAML 1.1 and 1.2 read it "
                                "differently; quote it)")
    return text


def _lines(text: str) -> List[Tuple[int, int, str, Optional[str]]]:
    """``(line number, indent, key, value text or None)`` of every
    mapping entry; blank and comment lines dropped."""
    out = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if "\t" in line:
            raise _fail(lineno, "a tab")
        body = line.lstrip(" ")
        if not body or body.startswith("#"):
            continue
        indent = len(line) - len(body)
        if body.startswith(("---", "...")) and indent == 0:
            raise _fail(lineno, "a document marker")
        m = _KEY.match(body)
        if m is None or body[m.end():m.end() + 1] != ":":
            raise _fail(lineno, f"the entry {body.strip()!r} (not 'key: value')")
        key, rest = m.group(), body[m.end() + 1:]
        if rest and not rest[0].isspace():
            raise _fail(lineno, f"the key {key!r} without a blank after ':'")
        if key in _NULL or key in _BOOL or _AMBIGUOUS[0].fullmatch(key):
            raise _fail(lineno, f"the key {key!r} (YAML reads it as no string)")
        value = None if _strip_comment(rest) == "" else rest
        out.append((lineno, indent, key, value))
    return out


def _mapping(entries, pos: int, indent: int) -> Tuple[Dict[str, Any], int]:
    """The block mapping whose entries sit at ``indent``, from ``pos``."""
    out: Dict[str, Any] = {}
    while pos < len(entries):
        lineno, ind, key, value = entries[pos]
        if ind < indent:
            break
        if ind > indent:
            raise _fail(lineno, "an indentation that matches no enclosing key")
        if key in out:
            raise _fail(lineno, f"the duplicate key {key!r}")
        pos += 1
        if value is not None:
            out[key] = _scalar(value, lineno)
        elif pos < len(entries) and entries[pos][1] > indent:
            out[key], pos = _mapping(entries, pos, entries[pos][1])
        else:
            out[key] = None  # "key:" with nothing below: null
    return out, pos


def parse_yaml(text: str) -> Dict[str, Any]:
    """A document of the subset above -> nested dicts (``{}`` when empty)."""
    entries = _lines(text)
    if not entries:
        return {}
    out, pos = _mapping(entries, 0, entries[0][1])
    if pos < len(entries):
        raise _fail(entries[pos][0], "an indentation that matches no enclosing key")
    return out


def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        text = repr(value)
        if not (_INT.fullmatch(text) or _FLOAT.fullmatch(text)):
            raise YAMLSubsetError(f"the number {text} has no form in the subset")
        return text
    if isinstance(value, str):
        if "\n" in value or "\r" in value:
            raise YAMLSubsetError(f"the string {value!r} has more than one line")
        return "'" + value.replace("'", "''") + "'"
    raise YAMLSubsetError(f"a {type(value).__name__} value has no form in the subset")


def to_yaml(data: Dict[str, Any], indent: int = 0) -> str:
    """Nested dicts of scalars as text of the subset that
    :func:`parse_yaml` reads back to an equal dict (strings single-quoted,
    two spaces a level)."""
    lines = []
    for key, value in data.items():
        if not isinstance(key, str) or not _KEY.fullmatch(key):
            raise YAMLSubsetError(f"the key {key!r} has no plain form in the subset")
        if isinstance(value, dict):
            if not value:
                raise YAMLSubsetError(f"the empty mapping {key!r} reads back as null")
            lines.append(" " * indent + f"{key}:")
            lines.append(to_yaml(value, indent + 2).rstrip("\n"))
        else:
            lines.append(" " * indent + f"{key}: {_dump_scalar(value)}")
    return "\n".join(lines) + "\n"


def read_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return parse_yaml(f.read())


def load_config(path: Optional[str] = None) -> Dict:
    """A config file merged over :data:`DEFAULTS` and validated; with no
    path, a deep copy of the defaults."""
    cfg = copy.deepcopy(DEFAULTS)
    if path is None:
        return cfg
    user = read_yaml(path) or {}
    for section, values in user.items():
        if section not in cfg:
            warnings.warn(f"config: unknown section '{section}' (ignored)")
            continue
        if not isinstance(values, dict):
            warnings.warn(f"config: section '{section}' is not a mapping")
            continue
        for key, value in values.items():
            if key not in cfg[section]:
                warnings.warn(f"config: unknown key '{section}.{key}' (kept)")
            if isinstance(cfg[section].get(key), dict) and isinstance(value, dict):
                # nested block (e.g. training.gating): merge over defaults
                for k2, v2 in value.items():
                    if k2 not in cfg[section][key]:
                        warnings.warn(f"config: unknown key '{section}.{key}.{k2}' (kept)")
                    cfg[section][key][k2] = v2
            else:
                cfg[section][key] = value
    # keep model.board_size consistent with game.size unless explicitly set
    if "model" not in user or "board_size" not in user.get("model", {}):
        cfg["model"]["board_size"] = cfg["game"]["size"]
    _validate(cfg)
    return cfg


def _validate(cfg: Dict) -> None:
    t = cfg["training"]
    for key in ("batch_size", "num_iterations", "self_play_episodes_per_iter",
                "train_epochs_per_iter", "checkpoint_interval", "replay_buffer_size"):
        if int(t[key]) <= 0:
            raise ValueError(f"training.{key} must be positive, got {t[key]}")
    if not (0.0 < float(t["lr"])):
        raise ValueError("training.lr must be > 0")
    if t.get("lr_schedule", "step") not in ("step", "constant"):
        raise ValueError("training.lr_schedule must be 'step' or 'constant'")
    gating = t.get("gating") or {}
    if not isinstance(gating, dict):
        raise ValueError(
            "training.gating must be a mapping, e.g. "
            "{enabled: true, games: 40, win_threshold: 0.55}; "
            f"got {t.get('gating')!r}"
        )
    if gating.get("enabled"):
        if int(gating.get("games", 40)) <= 0:
            raise ValueError("training.gating.games must be positive")
        if not (0.0 <= float(gating.get("win_threshold", 0.55)) <= 1.0):
            raise ValueError("training.gating.win_threshold must be in [0, 1]")
    m = cfg["mcts"]
    if int(m["num_simulations"]) <= 0:
        raise ValueError("mcts.num_simulations must be positive")
    if not (0.0 <= float(m["dirichlet_epsilon"]) <= 1.0):
        raise ValueError("mcts.dirichlet_epsilon must be in [0, 1]")
    g = cfg["game"]
    if int(g["size"]) not in (4, 6, 8):
        raise ValueError("game.size must be 4, 6 or 8")
    if g.get("rules", "reference") not in ("reference", "standard"):
        raise ValueError("game.rules must be 'reference' or 'standard'")
