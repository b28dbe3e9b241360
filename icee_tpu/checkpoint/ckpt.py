"""Checkpoint/resume.

Replaces the reference's two ad-hoc formats — per-epoch ``state_dict`` files
(``train.py:214-220``) and whole-module pickles with both optimizers and
BLEU bookkeeping (``utils.py:63-90``) — with ONE checkpoint
(``checkpoint/npz.py``: NumPy arrays + a JSON tree) holding params +
optimizer states + counters, saved as ``{mode}_checkpoint_{name}`` plus a
``{mode}_BEST_checkpoint_{name}`` copy on improvement, mirroring the
reference's naming contract.

Exact optax state types come back from a structure template (build a fresh
training state, then ``load_checkpoint(path, template)``) — the analogue of
the reference needing its module classes importable to unpickle.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import jax
import numpy as np

from icee_tpu.checkpoint import npz


@dataclasses.dataclass
class CheckpointState:
    """What a full checkpoint carries (reference ``utils.py:76-84``)."""

    epoch: int
    epochs_since_improvement: dict
    best_bleu4: dict
    params: Any                 # model parameter pytrees (per family layout)
    opt_states: Any             # optimizer state pytrees
    extra: Optional[dict] = None

    def as_pytree(self) -> dict:
        return {
            "epoch": np.asarray(self.epoch),
            "epochs_since_improvement": {
                k: np.asarray(v) for k, v in self.epochs_since_improvement.items()
            },
            "best_bleu4": {k: np.asarray(v) for k, v in self.best_bleu4.items()},
            "params": self.params,
            "opt_states": self.opt_states,
            "extra": self.extra or {},
        }


def _ckpt_path(folder: str, data_name: str, mode: str, best: bool) -> str:
    tag = f"{mode}_BEST_checkpoint_{data_name}" if best else \
        f"{mode}_checkpoint_{data_name}"
    return os.path.abspath(os.path.join(folder, tag))


def save_checkpoint(
    folder: str,
    data_name: str,
    mode: str,
    state: CheckpointState,
    is_best: bool,
) -> str:
    """Save ``{mode}_checkpoint_{data_name}`` (+ BEST copy when improved)."""
    os.makedirs(folder, exist_ok=True)
    tree = jax.tree_util.tree_map(np.asarray, state.as_pytree())
    meta = {"mode": mode, "data_name": data_name, "epoch": int(state.epoch)}
    path = npz.save_tree(_ckpt_path(folder, data_name, mode, best=False),
                         tree, meta)
    if is_best:
        npz.save_tree(_ckpt_path(folder, data_name, mode, best=True), tree,
                      meta)
    return path


def load_params(path: str) -> dict:
    """Raw-restore a checkpoint and return just its ``params`` subtree as
    jnp arrays — for inference/serving/tooling consumers that don't need the
    optimizer state (a full-structure template is only required to restore
    exact optax state types, see :func:`load_checkpoint`)."""
    import jax.numpy as jnp

    tree = npz.load_tree(path)
    return jax.tree_util.tree_map(jnp.asarray, tree["params"])


def load_checkpoint(path: str, template: Optional[dict] = None) -> dict:
    """Restore a checkpoint pytree.  ``template`` (same structure, abstract or
    concrete leaves) restores exact optax state types; without it the raw
    nested-dict form is returned."""
    return npz.load_tree(path, template)
