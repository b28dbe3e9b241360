"""Parameter initializers reproducing the reference's torch init semantics.

The reference initializes decoder parameters with
``nn.init.xavier_uniform_`` for every >=2-D tensor and zeros for biases
(``stylenet/model.py:99-105``), then overrides the embedding ``B`` and output
head ``C.weight`` with ``uniform_(-0.1, 0.1)`` and ``C.bias`` with zeros
(``:107-113``).  Plain torch layers (``nn.LSTM``/``nn.LSTMCell``/``nn.Linear``
used without an explicit reset, e.g. the encoder head and seq2seq models) use
torch's default ``U(-1/sqrt(fan), 1/sqrt(fan))``.

Weight layout convention: we store every linear weight as ``(in, out)`` so the
forward pass is ``x @ W + b`` (row-major, matmul-friendly).  Xavier-uniform is
symmetric in fan-in/fan-out so the distribution is identical to torch's
``(out, in)`` layout; torch default init bounds use ``fan_in = in`` which we
preserve explicitly.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def xavier_uniform(key: jax.Array, shape, dtype=jnp.float32) -> jax.Array:
    """torch ``nn.init.xavier_uniform_`` (gain=1).

    For a 2-D ``(in, out)`` weight: U(-a, a), a = sqrt(6 / (in + out)).
    Higher-rank tensors follow torch's fan computation: receptive field =
    prod(shape[2:]) with shape interpreted as (out, in, *rf); our stacked
    weights are plain 2-D/3-D matrices so we compute fans from the last two
    dims and treat leading dims as batch (each slice initialized like the
    reference's separate ``nn.Linear`` objects).
    """
    if len(shape) < 2:
        raise ValueError("xavier_uniform requires >=2-D shape")
    fan_in, fan_out = shape[-2], shape[-1]
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, minval=-a, maxval=a)


def uniform(key: jax.Array, shape, bound: float, dtype=jnp.float32) -> jax.Array:
    """U(-bound, bound) — embedding/output-head init (``model.py:111-113``)."""
    return jax.random.uniform(key, shape, dtype, minval=-bound, maxval=bound)


def torch_linear_default(key: jax.Array, shape, fan_in: int, dtype=jnp.float32):
    """torch ``nn.Linear``/``nn.LSTM`` default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return jax.random.uniform(key, shape, dtype, minval=-bound, maxval=bound)


def zeros(shape, dtype=jnp.float32) -> jax.Array:
    return jnp.zeros(shape, dtype)


def split_tree(key: jax.Array, n: int):
    """Convenience: split a key into a list of n keys."""
    return list(jax.random.split(key, n))
