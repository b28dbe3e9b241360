"""Mid-epoch progress checkpoints for device-resident training.

The whole-epoch device scans (``train/loops.py:_device_epoch_fn``) make an
epoch ONE dispatch — great for throughput, but a preempted run loses the
whole epoch.  The reference can't do better (its host loop resumes only at
epoch boundaries, ``stylenet/train_multitask.py:169-177``); this module goes
beyond it: with ``TrainConfig.progress_chunk > 0`` the epoch runs as chunks
of batch rows and a progress record lands on disk after every chunk, so a
killed long run resumes INSIDE the epoch, bit-identically.

The record is a plain pytree in the checkpoint format of
``checkpoint/npz.py``:

- ``epoch`` / ``pass_idx`` / ``row``: where the run was.  ``pass_idx``
  orders the passes inside one multitask epoch (0 = factual train,
  1 = emotion train); everything BEFORE ``pass_idx`` in that epoch is
  complete and already reflected in the record's params/counters.
- ``rng``: the trainer's RNG **carry at the chunk boundary** — the scan
  carries the key, so resuming the remaining rows with this key splits the
  exact same per-batch keys the uninterrupted scan would.
- ``params`` / ``opt_states``: the post-chunk training state.
- ``losses`` / ``ntoks``: the per-batch loss trace of the in-flight pass so
  far, padded to the full epoch length (rows >= ``row`` are zero) — the
  resumed epoch reports the same weighted epoch loss.
- plateau bookkeeping (``epochs_since_improvement`` / ``best_bleu4``), as
  of the record (mid-epoch these include any validation that already ran
  THIS epoch for earlier passes).

Loader shuffle state is NOT stored: ``DeviceCaptionData.epoch_indices`` is
deterministic from the seed and the number of prior calls, so resume
fast-forwards each train loader by calling it once per completed epoch
(``Trainer._resume_progress``).  Validation loaders are unshuffled and
consume no RNG.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax
import numpy as np

from icee_tpu.checkpoint import npz


def progress_path(folder: str, data_name: str) -> str:
    return os.path.abspath(
        os.path.join(folder, f"progress_checkpoint_{data_name}"))


def save_progress(folder: str, data_name: str, record: dict) -> str:
    """Crash-atomically replace ``progress_checkpoint_{data_name}``.

    A preemption is by definition likely to land DURING a save, so the
    previous record must survive until the new one is complete:
    :func:`icee_tpu.checkpoint.npz.save_tree` writes ``<path>.new`` first
    and swaps it in with two renames.  A kill at any instant leaves the
    previous record, its ``.old`` survivor, or the new record — never
    nothing."""
    os.makedirs(folder, exist_ok=True)
    tree = jax.tree_util.tree_map(np.asarray, record)
    return npz.save_tree(progress_path(folder, data_name), tree)


def peek_progress(folder: str, data_name: str) -> Optional[dict]:
    """Raw-restore the record (no template) to read its scalar position
    fields; returns None when no record exists.  The raw form is fine for
    scalars — ``load_progress`` re-restores with a template so the optax
    state types come back exact."""
    path = progress_path(folder, data_name)
    if npz.live_path(path) is None:
        return None
    return npz.load_tree(path)


def load_progress(folder: str, data_name: str, template: dict) -> dict:
    """Template-restore (exact optax state types, like ``ckpt.py``)."""
    return npz.load_tree(progress_path(folder, data_name), template)


def clear_progress(folder: str, data_name: str) -> None:
    """Remove the record and any swap remnants (training finished past
    it, or a stale interrupted save)."""
    npz.remove(progress_path(folder, data_name))


def make_record(
    epoch: int,
    pass_idx: int,
    row: int,
    rng: Any,
    params: dict,
    opt_states: dict,
    losses: np.ndarray,
    ntoks: np.ndarray,
    epochs_since_improvement: dict,
    best_bleu4: dict,
) -> dict:
    return {
        "epoch": np.asarray(epoch),
        "pass_idx": np.asarray(pass_idx),
        "row": np.asarray(row),
        "rng": np.asarray(rng),
        "params": params,
        "opt_states": opt_states,
        "losses": np.asarray(losses, np.float32),
        "ntoks": np.asarray(ntoks, np.float32),
        "epochs_since_improvement": {
            k: np.asarray(v) for k, v in epochs_since_improvement.items()},
        "best_bleu4": {k: np.asarray(v) for k, v in best_bleu4.items()},
    }
