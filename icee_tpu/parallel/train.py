"""Sharded training setup: place params/opt-state/batches on the mesh.

With GSPMD, the SAME jitted step functions from :mod:`icee_tpu.train.steps`
run data/tensor-parallel once their inputs are placed: jit propagates argument
shardings through the computation and inserts the gradient ``psum`` (data
axis) and the vocab-dim collectives (model axis) automatically; XLA hands
them to NCCL on the GPU.
This module owns the placement policy.
"""

from __future__ import annotations

from typing import Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from icee_tpu.parallel.mesh import (
    DATA_AXIS,
    batch_sharding,
    decoder_param_shardings,
    replicated,
    shard_pytree,
)


def place_decoder(dec_params: dict, mesh: Mesh) -> dict:
    """Vocab-sharded (tensor-parallel) decoder placement."""
    return shard_pytree(dec_params, decoder_param_shardings(dec_params, mesh))


def place_replicated(tree, mesh: Mesh):
    rep = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), tree)


def place_opt_state(opt_state, mesh: Mesh):
    """Optimizer moments follow their parameters' shardings automatically
    when initialized from placed params; this re-places a fresh/restored
    state by replicating scalars and leaving array placements to jit."""
    rep = replicated(mesh)

    def place(x):
        if hasattr(x, "ndim") and x.ndim == 0:
            return jax.device_put(x, rep)
        return x

    return jax.tree_util.tree_map(place, opt_state)


def place_batch(mesh: Mesh, *arrays):
    """Shard batch tensors over the data axis (leading dim)."""
    bs = batch_sharding(mesh)
    return tuple(jax.device_put(a, bs) for a in arrays)


def dp_tp_shape(n_devices: int, tp: int = 2) -> Tuple[int, int]:
    """Pick a (data, model) mesh shape: tp-way tensor parallel when it
    divides the device count, else pure DP."""
    if n_devices % tp == 0 and n_devices >= tp:
        return (n_devices // tp, tp)
    return (n_devices, 1)
