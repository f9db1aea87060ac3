"""Checkpoint I/O in the JAX package's pickle payload.

Counterpart of hnd_ghnd_tpu/utils/ckpt.py (reference
src/models/__init__.py:11-35): one file holding {params, state, opt_state,
lr_step, best_value, config, args, format_version 1}, written atomically
(a temporary file of the writing process's own, then os.replace; in a
multi-process run rank 0 writes, through ``multihost.save_on_master``).
``params`` and ``state`` are numpy trees in the JAX layout
(models/convert.jax_params_from_state_dict), so the JAX package's
``get_model`` loads a port checkpoint and the port loads a JAX one.

The port writes ``opt_state: None`` and keeps its own optimizer state, as
numpy arrays, under ``torch_opt_state``.  A JAX payload's ``opt_state``
pickles optax classes: ``load_ckpt`` reads it with an unpickler that turns
every ``optax``, ``jax`` and ``jaxlib`` class into an inert stub, so that
neither is imported; the port never uses that state (reading it is ROADMAP
A17).  The orbax backend is ROADMAP A16.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

FORMAT_VERSION = 1
_FOREIGN = ("optax", "jax", "jaxlib")


def save_ckpt(path: str, *, params, state=None, torch_opt_state=None,
              lr_step: Optional[int] = None, best_value: float = 0.0,
              config: Optional[dict] = None,
              args: Optional[dict] = None) -> None:
    """Write a checkpoint; creates parent dirs (reference
    make_parent_dirs).  ``params``/``state``: numpy trees in the JAX
    layout; ``torch_opt_state``: an optimizer ``state_dict`` with numpy
    arrays."""
    payload = {
        "params": params,
        "state": state,
        "opt_state": None,
        "torch_opt_state": torch_opt_state,
        "lr_step": lr_step,
        "best_value": best_value,
        "config": config,
        "args": args,
        "format_version": FORMAT_VERSION,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # a temporary file of this process's own: a reader never sees a partial
    # file, and two writing processes never share one
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class _Inert:
    """What a pickled optax/jax object becomes: it keeps the arguments it
    was rebuilt from and does nothing."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self._stubs: Dict[tuple, type] = {}

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _FOREIGN:
            key = (module, name)
            if key not in self._stubs:
                self._stubs[key] = type(name, (_Inert,), {"__module__": module})
            return self._stubs[key]
        return super().find_class(module, name)


def load_ckpt(path: str) -> Dict[str, Any]:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory: ROADMAP A16")
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if not isinstance(payload, dict) or "format_version" not in payload:
        raise ValueError(f"{path} is not a checkpoint payload")
    return payload


def check_if_exists(path: Optional[str]) -> bool:
    return path is not None and os.path.exists(path)
