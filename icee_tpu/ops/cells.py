"""Recurrent cell math in plain XLA; tests compare it with a NumPy oracle.

Gate stacking: the reference builds each gate from four separate ``nn.Linear``
modules (``stylenet/model.py:55-94``).  Here the four gates are one stacked
tensor per projection so every step is a handful of large matmuls instead
of 16 small ones:

- ``V``: (E_in, 4F)   word/context -> factored space, all gates at once
- ``S``: (num_styles, 4, F, F) per-style factor (selected by ``style`` id)
- ``U``: (4, F, H)    factored -> hidden
- ``W``: (H, 4H)      recurrent projection

Gate order is ``[i, f, o, c]`` for the factored cell (matching the reference's
naming) and torch's ``[i, f, g, o]`` for the standard cell (so torch LSTM
checkpoints import as a pure reshape).

Reference quirk preserved exactly: the FactoredLSTM emits ``h = o * c`` with
NO tanh on the cell state (``stylenet/model.py:153``) — trained reference
checkpoints depend on this, so it is not "fixed" here.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def factored_lstm_cell(
    params: dict,
    x: jax.Array,
    h: jax.Array,
    c: jax.Array,
    style: jax.Array | int,
) -> Tuple[jax.Array, jax.Array]:
    """One FactoredLSTM step (``stylenet/model.py:115-155``).

    x: (B, E_in); h, c: (B, H); style: scalar int id into the stacked style
    tensors (0=factual, 1=happy, 2=sad, 3=angry).
    Returns (h_new, c_new); the step's visible hidden equals ``h_new``.
    """
    f_dim = params["U_w"].shape[1]
    # V: (B, E_in) @ (E_in, 4F) -> (B, 4, F)
    v = (x @ params["V_w"]).reshape(x.shape[0], 4, f_dim) + params["V_b"]
    # per-style factor: batched over the gate axis
    s_w = jnp.take(params["S_w"], style, axis=0)  # (4, F, F)
    s_b = jnp.take(params["S_b"], style, axis=0)  # (4, F)
    s = jnp.einsum("bgf,gfk->bgk", v, s_w, preferred_element_type=jnp.float32) + s_b
    u = (
        jnp.einsum("bgf,gfh->bgh", s, params["U_w"], preferred_element_type=jnp.float32)
        + params["U_b"]
    )  # (B, 4, H)
    h_dim = h.shape[-1]
    w = (h @ params["W_w"]).reshape(h.shape[0], 4, h_dim) + params["W_b"]
    z = u + w
    i_t = jax.nn.sigmoid(z[:, 0])
    f_t = jax.nn.sigmoid(z[:, 1])
    o_t = jax.nn.sigmoid(z[:, 2])
    g_t = jnp.tanh(z[:, 3])
    c_new = f_t * c + i_t * g_t
    h_new = o_t * c_new  # reference quirk: no tanh (model.py:153)
    # bf16-in / f32-accumulate / bf16-out: keep the scan carry dtype stable
    return h_new.astype(h.dtype), c_new.astype(c.dtype)


def lstm_cell(
    params: dict, x: jax.Array, h: jax.Array, c: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Standard LSTM cell = torch ``nn.LSTMCell`` (``nic/model.py:51``).

    params: ``W_ih`` (E, 4H), ``W_hh`` (H, 4H), ``b_ih``/``b_hh`` (4H,) with
    torch's gate order [i, f, g, o] along the 4H axis.
    """
    z = x @ params["W_ih"] + params["b_ih"] + h @ params["W_hh"] + params["b_hh"]
    h_dim = h.shape[-1]
    i_t = jax.nn.sigmoid(z[..., 0 * h_dim : 1 * h_dim])
    f_t = jax.nn.sigmoid(z[..., 1 * h_dim : 2 * h_dim])
    g_t = jnp.tanh(z[..., 2 * h_dim : 3 * h_dim])
    o_t = jax.nn.sigmoid(z[..., 3 * h_dim : 4 * h_dim])
    c_new = f_t * c + i_t * g_t
    h_new = o_t * jnp.tanh(c_new)
    return h_new.astype(h.dtype), c_new.astype(c.dtype)


def multilayer_lstm_cell(
    params_layers: list,
    x: jax.Array,
    h: jax.Array,
    c: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Stack of standard LSTM cells = torch ``nn.LSTM`` step
    (``seq2seq/model.py:46-49``).  h, c: (num_layers, B, H).
    Returns (top hidden, h_new, c_new)."""
    hs, cs = [], []
    inp = x
    for layer, p in enumerate(params_layers):
        h_new, c_new = lstm_cell(p, inp, h[layer], c[layer])
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new
    return inp, jnp.stack(hs), jnp.stack(cs)
