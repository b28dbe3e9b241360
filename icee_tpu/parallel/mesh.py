"""Device mesh construction and sharding rules.

The reference has NO distributed execution (SURVEY.md §2.5: no DDP, no
torch.distributed, single ``cuda:0 or cpu`` device everywhere).  Here
parallelism is first-class:

- a 2-D ``jax.sharding.Mesh`` with axes ``("data", "model")``.  The GPUs of
  one host are joined all to all by NVLink, so the mesh follows the
  algorithm alone (no topology to respect); XLA hands its collectives to
  NCCL,
- **data parallelism**: the batch axis of every tensor shards over ``data``;
  XLA inserts the gradient all-reduce automatically,
- **tensor parallelism**: the vocabulary dimension of the embedding ``B``
  and the output head ``C`` — the only large matrices in these models —
  shards over ``model``; logits stay vocab-sharded until the loss, whose
  log-softmax reduction becomes a collective over ``model``,
- multi-host: :func:`init_distributed` wraps ``jax.distributed.initialize``.

Everything flows through ``jax.jit`` with ``NamedSharding`` constraints —
no hand-written collectives needed for these model sizes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ("data", "model") mesh.

    Default: all devices on the data axis (pure DP) — right for these
    LSTM-scale models; pass ``shape=(d, m)`` to carve out tensor parallelism
    for the vocab head on large-vocabulary runs.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (batch) sharding over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def data_shards(mesh: Optional[Mesh]) -> int:
    """Size of the mesh's data axis (1 when no mesh)."""
    if mesh is None:
        return 1
    return mesh.shape.get(DATA_AXIS, 1)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def decoder_param_shardings(params: dict, mesh: Mesh) -> dict:
    """PartitionSpecs for a decoder parameter pytree.

    Vocab-dimension tensors shard over ``model``; everything else (the small
    recurrent matrices) replicates.  Works for every decoder family: leaves
    named ``B``/``embed`` are (V, E) embeddings, ``C_w``/``linear_w`` are
    (H, V) heads, ``C_b``/``linear_b`` are (V,) biases.
    """
    vocab_rows = {"B", "embed"}
    vocab_cols = {"C_w", "linear_w"}
    vocab_vec = {"C_b", "linear_b"}
    tp = mesh.shape[MODEL_AXIS]

    def spec_for(path, leaf):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        # uneven shards are unsupported (device_put rejects them): a vocab
        # that doesn't divide the model axis replicates that leaf instead
        if name in vocab_rows and leaf.ndim >= 2 and leaf.shape[0] % tp == 0:
            return NamedSharding(mesh, P(MODEL_AXIS, *([None] * (leaf.ndim - 1))))
        if name in vocab_cols and leaf.ndim >= 2 and leaf.shape[-1] % tp == 0:
            return NamedSharding(
                mesh, P(*([None] * (leaf.ndim - 1)), MODEL_AXIS)
            )
        if name in vocab_vec and leaf.ndim == 1 and leaf.shape[0] % tp == 0:
            return NamedSharding(mesh, P(MODEL_AXIS))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(spec_for, params)


def shard_pytree(tree, shardings):
    """Place a pytree according to a matching sharding pytree."""
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), tree, shardings
    )


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (``jax.distributed.initialize``).  No-op on a
    single host with no coordinator configured."""
    if coordinator_address is None:
        return
    jax.distributed.initialize(coordinator_address, num_processes, process_id)
