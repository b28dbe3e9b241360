"""Multi-host data feeding: per-process example sharding + global arrays.

The reference is single-device (SURVEY.md §2.5); the scale-out
path is: every host loads ONLY its shard of the dataset, builds its local
slice of each global batch, and assembles a ``jax.Array`` spanning the mesh
with ``jax.make_array_from_process_local_data`` — the collective-free
multi-host input pattern (the "per-host data loading" row of §2.5).

Single-host runs degenerate gracefully (process_count == 1: the local data
IS the global batch), which is what the tests exercise; multi-host behavior
uses the same code path.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from icee_tpu.parallel.mesh import DATA_AXIS


def shard_examples(examples: Sequence, process_index: int | None = None,
                   process_count: int | None = None) -> list:
    """The contiguous slice of the dataset this host is responsible for.

    Hosts get near-equal contiguous slices; with shuffling handled by the
    per-host loader seed, this matches the standard jax multi-host input
    recipe (each process feeds only its addressable shard).
    """
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    n = len(examples)
    per = -(-n // pc)
    return list(examples[pi * per : (pi + 1) * per])


def global_batch(mesh: Mesh, local_batch: np.ndarray,
                 spec: P | None = None) -> jax.Array:
    """Assemble a mesh-spanning array from this process's local batch slice.

    ``local_batch`` is this host's rows of the global batch (global batch
    size = local rows x process_count along the data axis).
    """
    sharding = NamedSharding(mesh, spec if spec is not None else P(DATA_AXIS))
    return jax.make_array_from_process_local_data(sharding, local_batch)


def global_caption_batch(mesh: Mesh, batch) -> dict:
    """Lift a :class:`icee_tpu.data.pipeline.CaptionBatch`'s device tensors
    into mesh-spanning arrays (references stay host-local)."""
    out = {
        "captions": global_batch(mesh, np.asarray(batch.captions)),
        "lengths": global_batch(mesh, np.asarray(batch.lengths)),
        "sample_mask": global_batch(mesh, np.asarray(batch.sample_mask)),
    }
    if batch.images is not None:
        out["images"] = global_batch(mesh, np.asarray(batch.images))
    return out
