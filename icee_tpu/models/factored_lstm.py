"""StyleNet FactoredLSTM decoder in JAX.

Capability parity with ``DecoderFactoredLSTM`` (``stylenet/model.py:30-294``,
SURVEY.md M3/M4), re-designed for XLA:

- the four per-gate ``nn.Linear`` chains collapse into stacked tensors (see
  :mod:`icee_tpu.ops.cells`),
- the 4 style-specific S-matrix sets (factual/happy/sad/angry ×4 gates,
  ``model.py:54-91``) become one ``(num_styles, 4, F, F)`` tensor indexed by a
  traced style id — no Python branching, one compiled graph serves all modes,
- the per-timestep Python loop with batch shrinking (``model.py:180-191``)
  becomes a ``lax.scan`` over a static-length padded batch; invalid steps are
  masked in the loss instead of being sliced away,
- the per-step teacher-forcing coin flip shared across the batch
  (``model.py:181-184``) is a per-step Bernoulli vector drawn from a threaded
  PRNG key.

Init parity: Xavier-uniform for matrices / zeros for biases
(``model.py:99-105``), then ``B`` and ``C.weight`` ~ U(-0.1, 0.1), ``C.bias``
= 0 (``model.py:107-113``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from icee_tpu.core.config import DecoderConfig
from icee_tpu.core import initializers as init
from icee_tpu.ops.cells import factored_lstm_cell

State = Tuple[jax.Array, jax.Array]  # (h, c), each (B, H)


def init_params(key: jax.Array, cfg: DecoderConfig, dtype=jnp.float32) -> dict:
    """Parameter pytree for the factored decoder.

    Each stacked slice is initialized exactly like the reference's separate
    ``nn.Linear`` modules: per-gate Xavier with fans (in, out) of the
    corresponding unstacked matrix.
    """
    e_in, f, h, v = cfg.input_size, cfg.factored_size, cfg.hidden_size, cfg.vocab_size
    ns = cfg.num_styles
    ks = init.split_tree(key, 8)

    def stack_xavier(k, n, shape):
        keys = jax.random.split(k, n)
        return jnp.stack([init.xavier_uniform(kk, shape, dtype) for kk in keys])

    # V: 4 gates of (E_in -> F), stored (E_in, 4F) gate-major on the last axis
    v_w = stack_xavier(ks[0], 4, (e_in, f))                 # (4, E_in, F)
    v_w = jnp.transpose(v_w, (1, 0, 2)).reshape(e_in, 4 * f)
    s_w = jnp.stack(
        [stack_xavier(k, 4, (f, f)) for k in jax.random.split(ks[1], ns)]
    )                                                       # (ns, 4, F, F)
    u_w = stack_xavier(ks[2], 4, (f, h))                    # (4, F, H)
    w_w = stack_xavier(ks[3], 4, (h, h))                    # (4, H, H)
    w_w = jnp.transpose(w_w, (1, 0, 2)).reshape(h, 4 * h)
    return {
        "B": init.uniform(ks[4], (v, cfg.embed_size), 0.1, dtype),
        "V_w": v_w,
        "V_b": init.zeros((4, f), dtype),
        "S_w": s_w,
        "S_b": init.zeros((ns, 4, f), dtype),
        "U_w": u_w,
        "U_b": init.zeros((4, h), dtype),
        "W_w": w_w,
        "W_b": init.zeros((4, h), dtype),
        "C_w": init.uniform(ks[5], (h, v), 0.1, dtype),
        "C_b": init.zeros((v,), dtype),
    }


def embed(params: dict, tokens: jax.Array) -> jax.Array:
    return jnp.take(params["B"], tokens, axis=0)


def output_logits(params: dict, hidden: jax.Array) -> jax.Array:
    return hidden @ params["C_w"] + params["C_b"]


def initial_state(batch: int, cfg: DecoderConfig, dtype=jnp.float32) -> State:
    z = jnp.zeros((batch, cfg.hidden_size), dtype)
    return z, z


def decode_step(
    params: dict, x: jax.Array, state: State, style: jax.Array
) -> Tuple[jax.Array, State]:
    """One inference step: input embedding/feature -> vocab logits.

    Used by greedy/beam decoding (``model.py:222-231`` inner loop).
    """
    h, c = state
    h, c = factored_lstm_cell(params, x, h, c, style)
    return output_logits(params, h), (h, c)


def forward(
    params: dict,
    cfg: DecoderConfig,
    captions: jax.Array,            # (B, T) int32
    features: Optional[jax.Array],  # (B, E) or None (text-only style corpus)
    style: jax.Array | int,
    teacher_forcing_ratio: float = 0.8,
    rng: Optional[jax.Array] = None,
    train: bool = True,
) -> jax.Array:
    """Teacher-forced/scheduled training forward -> logits (B, T, V).

    Step ``t`` predicts ``captions[:, t]``; with ``features`` given, step 0
    consumes the image feature and step t>=1 consumes the embedding of
    ``captions[:, t-1]`` (reference prepends the feature, ``model.py:170-174``).
    Without features, step t consumes ``captions[:, t]`` itself (the stale
    paper-regime semantics of ``train.py``; preserved for parity).

    Scheduled sampling: one coin per timestep shared across the batch; on a
    "free" step the input is the UN-dropped embedding of the previous argmax
    prediction (``model.py:180-191``).  ``teacher_forcing_ratio=0`` gives the
    fully free-running validation path (``train_multitask.py:295-299``).
    """
    if isinstance(teacher_forcing_ratio, float) and teacher_forcing_ratio >= 1.0:
        hiddens = forward_hiddens(
            params, cfg, captions, features, style, teacher_forcing_ratio,
            rng, train)
        # the vocab head runs ONCE over all timesteps — one (B*T, H) @ (H, V)
        # matmul instead of T small ones
        return hiddens @ params["C_w"] + params["C_b"]

    teacher_inputs, coins, style, (h0, c0) = _prep_forward(
        params, cfg, captions, features, style, teacher_forcing_ratio, rng,
        train)

    def body(carry, xs):
        (h, c, prev) = carry
        x_teacher, coin = xs
        x_free = embed(params, prev)
        x = jnp.where(coin, x_teacher, x_free)
        h, c = factored_lstm_cell(params, x, h, c, style)
        logits = output_logits(params, h)
        prev = jnp.argmax(logits, axis=-1)
        return (h, c, prev), logits

    prev0 = captions[:, 0]
    _, logits = jax.lax.scan(
        body, (h0, c0, prev0), (jnp.swapaxes(teacher_inputs, 0, 1), coins)
    )
    return jnp.swapaxes(logits, 0, 1)  # (B, T, V)


def _prep_forward(params, cfg, captions, features, style,
                  teacher_forcing_ratio, rng, train):
    """Shared training-forward prologue: embedded (dropped-out) teacher
    inputs with the feature prepended, per-step coins, initial state."""
    b, t = captions.shape
    if rng is None:
        rng = jax.random.PRNGKey(0)
    k_drop, k_tf = jax.random.split(rng)

    emb = embed(params, captions)  # (B, T, E)
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
    return teacher_inputs, coins, jnp.asarray(style), initial_state(
        b, cfg, emb.dtype)


def forward_hiddens(
    params: dict,
    cfg: DecoderConfig,
    captions: jax.Array,
    features: Optional[jax.Array],
    style: jax.Array | int,
    teacher_forcing_ratio: float = 0.8,
    rng: Optional[jax.Array] = None,
    train: bool = True,
) -> jax.Array:
    """Training forward -> hidden states (B, T, H); same semantics as
    :func:`forward` with the vocab head left to the caller.

    The chunked training loss (``ops/chunked_loss.py``) consumes this so the
    (B, T, V) logits never materialize in HBM.  On the scheduled-sampling
    path the head still runs per step to pick the argmax feedback token, but
    those transient logits carry no gradient (argmax is non-differentiable)
    and are never stacked.
    """
    teacher_inputs, coins, style, (h0, c0) = _prep_forward(
        params, cfg, captions, features, style, teacher_forcing_ratio, rng,
        train)

    if coins is None:
        # fully teacher-forced fast path (ratio 1.0 == the reference's
        # always-true coin): no argmax feedback, scan carries only (h, c)
        def cell_body(carry, x_t):
            h, c = carry
            h, c = factored_lstm_cell(params, x_t, h, c, style)
            return (h, c), h

        _, hiddens = jax.lax.scan(
            cell_body, (h0, c0), jnp.swapaxes(teacher_inputs, 0, 1))
        return jnp.swapaxes(hiddens, 0, 1)  # (B, T, H)

    def body(carry, xs):
        (h, c, prev) = carry
        x_teacher, coin = xs
        x_free = embed(params, prev)
        x = jnp.where(coin, x_teacher, x_free)
        h, c = factored_lstm_cell(params, x, h, c, style)
        logits = output_logits(params, jax.lax.stop_gradient(h))
        prev = jnp.argmax(logits, axis=-1)
        return (h, c, prev), h

    prev0 = captions[:, 0]
    _, hiddens = jax.lax.scan(
        body, (h0, c0, prev0), (jnp.swapaxes(teacher_inputs, 0, 1), coins)
    )
    return jnp.swapaxes(hiddens, 0, 1)  # (B, T, H)


# --- parameter-group helpers (optimizer masking) -------------------------

def style_param_mask(params: dict, include_output_head: bool = True) -> dict:
    """Boolean mask pytree selecting the style S tensors (+ optionally C).

    The transfer fine-tuner optimizes only the style factors and the output
    head (``stylenet/train_transfer.py:94-115``); the paper regime's per-
    emotion optimizers cover single style slices (``train.py:135-150``).
    With stacked styles this is an ``optax.masked`` transform over S_w/S_b
    (and C_w/C_b).
    """
    mask = jax.tree_util.tree_map(lambda _: False, params)
    mask["S_w"] = True
    mask["S_b"] = True
    if include_output_head:
        mask["C_w"] = True
        mask["C_b"] = True
    return mask
