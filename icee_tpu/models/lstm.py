"""NIC (Show-and-Tell) decoder and generic multi-layer LSTM in JAX.

Parity targets: ``DecoderRNN`` (``nic/model.py:30-207``, SURVEY.md M6) — the
StyleNet scaffolding with a stock ``nn.LSTMCell`` — plus the multi-layer
``nn.LSTM`` step used by the seq2seq family (``seq2seq/model.py:46-66``).

Same design as :mod:`icee_tpu.models.factored_lstm`: ``lax.scan`` over a
static padded batch, per-step shared teacher-forcing coin, masked loss outside.

Init parity (``nic/model.py:56-70``): Xavier for >=2-D params, zero biases,
then ``embed``/``linear.weight`` ~ U(-0.1, 0.1), ``linear.bias`` = 0.  The
LSTMCell matrices are Xavier'd per torch layout ``(4H, in)`` — fans (in, 4H) —
so we initialize the transposed ``(in, 4H)`` matrix with the same fans.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from icee_tpu.core.config import DecoderConfig, Seq2SeqConfig
from icee_tpu.core import initializers as init
from icee_tpu.ops.cells import lstm_cell, multilayer_lstm_cell

State = Tuple[jax.Array, jax.Array]


def _xavier_lstm_matrix(key, in_dim: int, h_dim: int, dtype) -> jax.Array:
    """Xavier-uniform for a torch LSTM weight of shape (4H, in), stored
    transposed as (in, 4H).  torch computes fans from the (4H, in) layout:
    fan_in = in, fan_out = 4H."""
    a = math.sqrt(6.0 / (in_dim + 4 * h_dim))
    return jax.random.uniform(key, (in_dim, 4 * h_dim), dtype, minval=-a, maxval=a)


def init_cell_params(
    key: jax.Array, in_dim: int, h_dim: int, dtype=jnp.float32, xavier: bool = True
) -> dict:
    """One LSTM cell/layer. ``xavier=True`` matches the reference's explicit
    reset (nic/model.py:56-63); ``xavier=False`` keeps torch's default
    U(-1/sqrt(H)) init (used by seq2seq, which never resets)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    if xavier:
        return {
            "W_ih": _xavier_lstm_matrix(k1, in_dim, h_dim, dtype),
            "W_hh": _xavier_lstm_matrix(k2, h_dim, h_dim, dtype),
            "b_ih": init.zeros((4 * h_dim,), dtype),
            "b_hh": init.zeros((4 * h_dim,), dtype),
        }
    return {
        "W_ih": init.torch_linear_default(k1, (in_dim, 4 * h_dim), h_dim, dtype),
        "W_hh": init.torch_linear_default(k2, (h_dim, 4 * h_dim), h_dim, dtype),
        "b_ih": init.torch_linear_default(k3, (4 * h_dim,), h_dim, dtype),
        "b_hh": init.torch_linear_default(k4, (4 * h_dim,), h_dim, dtype),
    }


def init_params(key: jax.Array, cfg: DecoderConfig, dtype=jnp.float32) -> dict:
    """NIC decoder parameters (single LSTMCell regardless of num_layers, as in
    ``nic/model.py:51``)."""
    e, h, v = cfg.embed_size, cfg.hidden_size, cfg.vocab_size
    ks = init.split_tree(key, 4)
    return {
        "embed": init.uniform(ks[0], (v, e), 0.1, dtype),
        "cell": init_cell_params(ks[1], e, h, dtype, xavier=True),
        "linear_w": init.uniform(ks[2], (h, v), 0.1, dtype),
        "linear_b": init.zeros((v,), dtype),
    }


def embed(params: dict, tokens: jax.Array) -> jax.Array:
    return jnp.take(params["embed"], tokens, axis=0)


def output_logits(params: dict, hidden: jax.Array) -> jax.Array:
    return hidden @ params["linear_w"] + params["linear_b"]


def initial_state(batch: int, cfg: DecoderConfig, dtype=jnp.float32) -> State:
    z = jnp.zeros((batch, cfg.hidden_size), dtype)
    return z, z


def decode_step(params: dict, x: jax.Array, state: State) -> Tuple[jax.Array, State]:
    h, c = state
    h, c = lstm_cell(params["cell"], x, h, c)
    return output_logits(params, h), (h, c)


def forward(
    params: dict,
    cfg: DecoderConfig,
    captions: jax.Array,
    features: Optional[jax.Array],
    teacher_forcing_ratio: float = 0.8,
    rng: Optional[jax.Array] = None,
    train: bool = True,
) -> jax.Array:
    """Training forward -> logits (B, T, V); semantics identical to the
    FactoredLSTM forward (feature prepended as step-0 input,
    ``nic/model.py:82-111``)."""
    if isinstance(teacher_forcing_ratio, float) and teacher_forcing_ratio >= 1.0:
        hiddens = forward_hiddens(params, cfg, captions, features,
                                  teacher_forcing_ratio, rng, train)
        return hiddens @ params["linear_w"] + params["linear_b"]

    teacher_inputs, coins, (h0, c0) = _prep_forward(
        params, cfg, captions, features, teacher_forcing_ratio, rng, train)

    def body(carry, xs):
        h, c, prev = carry
        x_teacher, coin = xs
        x = jnp.where(coin, x_teacher, embed(params, prev))
        h, c = lstm_cell(params["cell"], x, h, c)
        logits = output_logits(params, h)
        return (h, c, jnp.argmax(logits, axis=-1)), logits

    _, logits = jax.lax.scan(
        body, (h0, c0, captions[:, 0]), (jnp.swapaxes(teacher_inputs, 0, 1), coins)
    )
    return jnp.swapaxes(logits, 0, 1)


def _prep_forward(params, cfg, captions, features, teacher_forcing_ratio,
                  rng, train):
    b, t = captions.shape
    if rng is None:
        rng = jax.random.PRNGKey(0)
    k_drop, k_tf = jax.random.split(rng)

    emb = embed(params, captions)
    if train and cfg.dropout > 0.0:
        keep = jax.random.bernoulli(k_drop, 1.0 - cfg.dropout, emb.shape)
        emb = jnp.where(keep, emb / (1.0 - cfg.dropout), 0.0)

    if features is not None:
        teacher_inputs = jnp.concatenate(
            [features[:, None, :].astype(emb.dtype), emb[:, :-1]], axis=1
        )
    else:
        teacher_inputs = emb

    if (isinstance(teacher_forcing_ratio, float)
            and teacher_forcing_ratio >= 1.0):
        coins = None
    else:
        coins = jax.random.bernoulli(k_tf, teacher_forcing_ratio, (t,))
    return teacher_inputs, coins, initial_state(b, cfg, emb.dtype)


def forward_hiddens(
    params: dict,
    cfg: DecoderConfig,
    captions: jax.Array,
    features: Optional[jax.Array],
    teacher_forcing_ratio: float = 0.8,
    rng: Optional[jax.Array] = None,
    train: bool = True,
) -> jax.Array:
    """Training forward -> hidden states (B, T, H); the vocab head is left
    to the caller (see ``ops/chunked_loss.py`` and the FactoredLSTM
    counterpart for semantics)."""
    teacher_inputs, coins, (h0, c0) = _prep_forward(
        params, cfg, captions, features, teacher_forcing_ratio, rng, train)

    if coins is None:
        def cell_body(carry, x_t):
            h, c = carry
            h, c = lstm_cell(params["cell"], x_t, h, c)
            return (h, c), h

        _, hiddens = jax.lax.scan(
            cell_body, (h0, c0), jnp.swapaxes(teacher_inputs, 0, 1))
        return jnp.swapaxes(hiddens, 0, 1)

    def body(carry, xs):
        h, c, prev = carry
        x_teacher, coin = xs
        x = jnp.where(coin, x_teacher, embed(params, prev))
        h, c = lstm_cell(params["cell"], x, h, c)
        logits = output_logits(params, jax.lax.stop_gradient(h))
        return (h, c, jnp.argmax(logits, axis=-1)), h

    _, hiddens = jax.lax.scan(
        body, (h0, c0, captions[:, 0]), (jnp.swapaxes(teacher_inputs, 0, 1), coins)
    )
    return jnp.swapaxes(hiddens, 0, 1)


# --- multi-layer LSTM (seq2seq building block) ---------------------------

def init_multilayer(
    key: jax.Array,
    in_dim: int,
    h_dim: int,
    num_layers: int,
    dtype=jnp.float32,
    xavier: bool = False,
) -> List[dict]:
    """torch ``nn.LSTM(in, H, num_layers)`` parameter stack."""
    keys = jax.random.split(key, num_layers)
    return [
        init_cell_params(
            keys[i], in_dim if i == 0 else h_dim, h_dim, dtype, xavier=xavier
        )
        for i in range(num_layers)
    ]


def multilayer_initial_state(
    num_layers: int, batch: int, h_dim: int, dtype=jnp.float32
) -> State:
    z = jnp.zeros((num_layers, batch, h_dim), dtype)
    return z, z


def multilayer_decode_step(
    params_layers: List[dict], x: jax.Array, state: State
) -> Tuple[jax.Array, State]:
    h, c = state
    top, h, c = multilayer_lstm_cell(params_layers, x, h, c)
    return top, (h, c)
