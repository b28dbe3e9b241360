"""Attention decoders (StyleNet+Att and NIC+Att) in JAX.

Parity targets: ``Attention`` and ``DecoderFactoredLSTMAtt``
(``stylenet/model_att.py:32-426``, SURVEY.md M5) and ``DecoderRNNAtt``
(``nic/model_att.py:73-306``, M7):

- Bahdanau-style additive attention over the 14x14=196 spatial grid
  (``model_att.py:51-70``), with ONE attention net per style for the factored
  decoder (``:140-161``) — here stacked into ``(num_styles, ...)`` tensors
  indexed by the traced style id,
- sigmoid gating scalar ``f_beta(h)`` on the context (``:283-284``),
- h/c initialized from the mean image feature (``:185-194``),
- per-step input ``[word_emb ; gated context]`` (``:290``),
- forward returns ``(logits, alphas)`` so trainers can add the
  doubly-stochastic regularizer (``train_multitask_att.py:322-323``).

The attention trainers use shifted teacher forcing (input ``captions[:,:-1]``,
target ``captions[:,1:]``; ``train_multitask_att.py:308-311``) — that shift
lives in the trainer; this forward consumes whatever caption slice it is given.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from icee_tpu.core.config import AttentionDecoderConfig
from icee_tpu.core import initializers as init
from icee_tpu.ops.cells import factored_lstm_cell, lstm_cell


State = Tuple[jax.Array, jax.Array]


# --- additive attention --------------------------------------------------

def init_attention(key: jax.Array, enc_dim: int, dec_dim: int, att_dim: int,
                   dtype=jnp.float32) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "enc_w": init.xavier_uniform(k1, (enc_dim, att_dim), dtype),
        "enc_b": init.zeros((att_dim,), dtype),
        "dec_w": init.xavier_uniform(k2, (dec_dim, att_dim), dtype),
        "dec_b": init.zeros((att_dim,), dtype),
        "full_w": init.xavier_uniform(k3, (att_dim, 1), dtype),
        "full_b": init.zeros((1,), dtype),
    }


def attend(att: dict, features: jax.Array, hidden: jax.Array
           ) -> Tuple[jax.Array, jax.Array]:
    """features (B, P, enc_dim), hidden (B, dec_dim) ->
    (context (B, enc_dim), alpha (B, P)) — ``model_att.py:51-70``."""
    att1 = features @ att["enc_w"] + att["enc_b"]            # (B, P, A)
    return attend_precomputed(att, att1, features, hidden)


def attend_precomputed(att: dict, att1: jax.Array, features: jax.Array,
                       hidden: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Attention with the encoder projection hoisted out of the time loop.

    ``att1 = features @ enc_w + enc_b`` is h-independent, so computing it
    once per sequence instead of once per step (the reference recomputes it
    every call, ``model_att.py:59``) is bit-identical and removes the
    dominant (P x enc_dim x A) matmul from every decode/scan step."""
    att2 = hidden @ att["dec_w"] + att["dec_b"]              # (B, A)
    e = jax.nn.relu(att1 + att2[:, None, :]) @ att["full_w"] # (B, P, 1)
    e = e[..., 0] + att["full_b"]
    alpha = jax.nn.softmax(e, axis=1)
    context = jnp.sum(features * alpha[..., None], axis=1)
    return context, alpha


def _stack_attention(keys, enc_dim, dec_dim, att_dim, dtype) -> dict:
    atts = [init_attention(k, enc_dim, dec_dim, att_dim, dtype) for k in keys]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *atts)


def _select_attention(stacked: dict, style) -> dict:
    return jax.tree_util.tree_map(lambda x: jnp.take(x, style, axis=0), stacked)


# --- StyleNet factored attention decoder ---------------------------------

def init_factored_att_params(
    key: jax.Array, cfg: AttentionDecoderConfig, dtype=jnp.float32
) -> dict:
    """DecoderFactoredLSTMAtt parameters; factored-cell tensors are built by
    :func:`icee_tpu.models.factored_lstm.init_params` with the widened input
    (E + feature_size) and reused unchanged."""
    from icee_tpu.models import factored_lstm

    k_core, k_att, k_init, k_beta = jax.random.split(key, 4)
    params = factored_lstm.init_params(k_core, cfg, dtype)
    fs, hs, att_dim = cfg.feature_size, cfg.hidden_size, cfg.attention_size
    params["attention"] = _stack_attention(
        jax.random.split(k_att, cfg.num_styles), fs, hs, att_dim, dtype
    )
    ki1, ki2 = jax.random.split(k_init)
    params["init_h_w"] = init.xavier_uniform(ki1, (fs, hs), dtype)
    params["init_h_b"] = init.zeros((hs,), dtype)
    params["init_c_w"] = init.xavier_uniform(ki2, (fs, hs), dtype)
    params["init_c_b"] = init.zeros((hs,), dtype)
    params["f_beta_w"] = init.xavier_uniform(k_beta, (hs, fs), dtype)
    params["f_beta_b"] = init.zeros((fs,), dtype)
    return params


def init_hidden_state(params: dict, features: jax.Array) -> State:
    """h/c from the mean spatial feature (``model_att.py:185-194``).
    features: (B, P, enc_dim)."""
    mean = jnp.mean(features, axis=1)
    h = mean @ params["init_h_w"] + params["init_h_b"]
    c = mean @ params["init_c_w"] + params["init_c_b"]
    return h, c


def _gated_context(params: dict, att: dict, features: jax.Array, h: jax.Array
                   ) -> Tuple[jax.Array, jax.Array]:
    context, alpha = attend(att, features, h)
    gate = jax.nn.sigmoid(h @ params["f_beta_w"] + params["f_beta_b"])
    return gate * context, alpha


def _gated_context_pre(params: dict, att: dict, att1: jax.Array,
                       features: jax.Array, h: jax.Array
                       ) -> Tuple[jax.Array, jax.Array]:
    context, alpha = attend_precomputed(att, att1, features, h)
    gate = jax.nn.sigmoid(h @ params["f_beta_w"] + params["f_beta_b"])
    return gate * context, alpha


def factored_att_decode_step(
    params: dict,
    emb: jax.Array,        # (B, E) word embedding
    features: jax.Array,   # (B, P, enc_dim)
    state: State,
    style: jax.Array,
    att1: "jax.Array | None" = None,  # optional hoisted encoder projection
) -> Tuple[jax.Array, jax.Array, State]:
    """One inference step -> (logits, alpha, new_state)
    (``model_att.py:348-364`` beam inner loop).  Pass ``att1 = features @
    enc_w + enc_b`` (per style) to skip the per-step encoder projection."""
    from icee_tpu.models.factored_lstm import output_logits

    h, c = state
    att = _select_attention(params["attention"], style)
    if att1 is None:
        att1 = features @ att["enc_w"] + att["enc_b"]
    context, alpha = _gated_context_pre(params, att, att1, features, h)
    x = jnp.concatenate([emb, context], axis=-1)
    h, c = factored_lstm_cell(params, x, h, c, style)
    return output_logits(params, h), alpha, (h, c)


def factored_att_forward(
    params: dict,
    cfg: AttentionDecoderConfig,
    captions: jax.Array,     # (B, T) — trainer passes the shifted slice
    features: jax.Array,     # (B, P, enc_dim) flattened spatial grid
    style: jax.Array | int,
    teacher_forcing_ratio: float = 0.8,
    rng: Optional[jax.Array] = None,
    train: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Training forward -> (logits (B,T,V), alphas (B,T,P))
    (``model_att.py:238-305``)."""
    from icee_tpu.models.factored_lstm import embed, output_logits

    b, t = captions.shape
    if rng is None:
        rng = jax.random.PRNGKey(0)
    k_drop, k_tf = jax.random.split(rng)

    emb_seq = embed(params, captions)
    if train and cfg.dropout > 0.0:
        keep = jax.random.bernoulli(k_drop, 1.0 - cfg.dropout, emb_seq.shape)
        emb_seq = jnp.where(keep, emb_seq / (1.0 - cfg.dropout), 0.0)

    coins = jax.random.bernoulli(k_tf, teacher_forcing_ratio, (t,))
    style = jnp.asarray(style)
    att = _select_attention(params["attention"], style)
    # hoisted: the encoder-side projection is h-independent (see
    # attend_precomputed) — one matmul per sequence instead of per step
    att1 = features @ att["enc_w"] + att["enc_b"]

    def body(carry, xs):
        h, c, prev = carry
        emb_teacher, coin = xs
        context, alpha = _gated_context_pre(params, att, att1, features, h)
        e = jnp.where(coin, emb_teacher, embed(params, prev))
        x = jnp.concatenate([e, context], axis=-1)
        h, c = factored_lstm_cell(params, x, h, c, style)
        logits = output_logits(params, h)
        return (h, c, jnp.argmax(logits, axis=-1)), (logits, alpha)

    h0, c0 = init_hidden_state(params, features)
    _, (logits, alphas) = jax.lax.scan(
        body, (h0, c0, captions[:, 0]), (jnp.swapaxes(emb_seq, 0, 1), coins)
    )
    return jnp.swapaxes(logits, 0, 1), jnp.swapaxes(alphas, 0, 1)


def factored_att_forward_hiddens(
    params: dict,
    cfg: AttentionDecoderConfig,
    captions: jax.Array,
    features: jax.Array,
    style: jax.Array | int,
    teacher_forcing_ratio: float = 0.8,
    rng: Optional[jax.Array] = None,
    train: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Training forward -> (hiddens (B,T,H), alphas (B,T,P)); the vocab head
    is left to the caller (chunked loss, ``ops/chunked_loss.py``).  On the
    scheduled-sampling path the head runs per step only to pick the argmax
    feedback token (no gradient; never stacked)."""
    from icee_tpu.models.factored_lstm import embed, output_logits

    b, t = captions.shape
    if rng is None:
        rng = jax.random.PRNGKey(0)
    k_drop, k_tf = jax.random.split(rng)

    emb_seq = embed(params, captions)
    if train and cfg.dropout > 0.0:
        keep = jax.random.bernoulli(k_drop, 1.0 - cfg.dropout, emb_seq.shape)
        emb_seq = jnp.where(keep, emb_seq / (1.0 - cfg.dropout), 0.0)

    style = jnp.asarray(style)
    att = _select_attention(params["attention"], style)
    att1 = features @ att["enc_w"] + att["enc_b"]
    h0, c0 = init_hidden_state(params, features)

    if (isinstance(teacher_forcing_ratio, float)
            and teacher_forcing_ratio >= 1.0):
        def tf_body(carry, emb_teacher):
            h, c = carry
            context, alpha = _gated_context_pre(params, att, att1, features, h)
            x = jnp.concatenate([emb_teacher, context], axis=-1)
            h, c = factored_lstm_cell(params, x, h, c, style)
            return (h, c), (h, alpha)

        _, (hiddens, alphas) = jax.lax.scan(
            tf_body, (h0, c0), jnp.swapaxes(emb_seq, 0, 1))
        return jnp.swapaxes(hiddens, 0, 1), jnp.swapaxes(alphas, 0, 1)

    coins = jax.random.bernoulli(k_tf, teacher_forcing_ratio, (t,))

    def body(carry, xs):
        h, c, prev = carry
        emb_teacher, coin = xs
        context, alpha = _gated_context_pre(params, att, att1, features, h)
        e = jnp.where(coin, emb_teacher, embed(params, prev))
        x = jnp.concatenate([e, context], axis=-1)
        h, c = factored_lstm_cell(params, x, h, c, style)
        logits = output_logits(params, jax.lax.stop_gradient(h))
        return (h, c, jnp.argmax(logits, axis=-1)), (h, alpha)

    _, (hiddens, alphas) = jax.lax.scan(
        body, (h0, c0, captions[:, 0]), (jnp.swapaxes(emb_seq, 0, 1), coins)
    )
    return jnp.swapaxes(hiddens, 0, 1), jnp.swapaxes(alphas, 0, 1)


# --- NIC attention decoder ----------------------------------------------

def init_rnn_att_params(
    key: jax.Array, cfg: AttentionDecoderConfig, dtype=jnp.float32
) -> dict:
    """DecoderRNNAtt: single attention net + LSTMCell(E+feature -> H)
    (``nic/model_att.py:73-161``), Xavier reset."""
    from icee_tpu.models.lstm import init_cell_params

    k_emb, k_cell, k_out, k_att, k_init, k_beta = jax.random.split(key, 6)
    fs, hs, att_dim = cfg.feature_size, cfg.hidden_size, cfg.attention_size
    ki1, ki2 = jax.random.split(k_init)
    return {
        "embed": init.uniform(k_emb, (cfg.vocab_size, cfg.embed_size), 0.1, dtype),
        "cell": init_cell_params(k_cell, cfg.embed_size + fs, hs, dtype, xavier=True),
        "linear_w": init.uniform(k_out, (hs, cfg.vocab_size), 0.1, dtype),
        "linear_b": init.zeros((cfg.vocab_size,), dtype),
        "attention": init_attention(k_att, fs, hs, att_dim, dtype),
        "init_h_w": init.xavier_uniform(ki1, (fs, hs), dtype),
        "init_h_b": init.zeros((hs,), dtype),
        "init_c_w": init.xavier_uniform(ki2, (fs, hs), dtype),
        "init_c_b": init.zeros((hs,), dtype),
        "f_beta_w": init.xavier_uniform(k_beta, (hs, fs), dtype),
        "f_beta_b": init.zeros((fs,), dtype),
    }


def rnn_att_decode_step(
    params: dict, emb: jax.Array, features: jax.Array, state: State,
    att1: "jax.Array | None" = None,
) -> Tuple[jax.Array, jax.Array, State]:
    h, c = state
    att = params["attention"]
    if att1 is None:
        att1 = features @ att["enc_w"] + att["enc_b"]
    context, alpha = _gated_context_pre(params, att, att1, features, h)
    x = jnp.concatenate([emb, context], axis=-1)
    h, c = lstm_cell(params["cell"], x, h, c)
    logits = h @ params["linear_w"] + params["linear_b"]
    return logits, alpha, (h, c)


def rnn_att_forward(
    params: dict,
    cfg: AttentionDecoderConfig,
    captions: jax.Array,
    features: jax.Array,
    teacher_forcing_ratio: float = 0.8,
    rng: Optional[jax.Array] = None,
    train: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """NIC+Att training forward (``nic/model_att.py:217-281``)."""
    b, t = captions.shape
    if rng is None:
        rng = jax.random.PRNGKey(0)
    k_drop, k_tf = jax.random.split(rng)

    emb_seq = jnp.take(params["embed"], captions, axis=0)
    if train and cfg.dropout > 0.0:
        keep = jax.random.bernoulli(k_drop, 1.0 - cfg.dropout, emb_seq.shape)
        emb_seq = jnp.where(keep, emb_seq / (1.0 - cfg.dropout), 0.0)

    coins = jax.random.bernoulli(k_tf, teacher_forcing_ratio, (t,))
    att = params["attention"]
    att1 = features @ att["enc_w"] + att["enc_b"]  # hoisted (h-independent)

    def body(carry, xs):
        h, c, prev = carry
        emb_teacher, coin = xs
        context, alpha = _gated_context_pre(params, att, att1, features, h)
        e = jnp.where(coin, emb_teacher, jnp.take(params["embed"], prev, axis=0))
        x = jnp.concatenate([e, context], axis=-1)
        h, c = lstm_cell(params["cell"], x, h, c)
        logits = h @ params["linear_w"] + params["linear_b"]
        return (h, c, jnp.argmax(logits, axis=-1)), (logits, alpha)

    h0, c0 = init_hidden_state(params, features)
    _, (logits, alphas) = jax.lax.scan(
        body, (h0, c0, captions[:, 0]), (jnp.swapaxes(emb_seq, 0, 1), coins)
    )
    return jnp.swapaxes(logits, 0, 1), jnp.swapaxes(alphas, 0, 1)


def rnn_att_forward_hiddens(
    params: dict,
    cfg: AttentionDecoderConfig,
    captions: jax.Array,
    features: jax.Array,
    teacher_forcing_ratio: float = 0.8,
    rng: Optional[jax.Array] = None,
    train: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """NIC+Att training forward -> (hiddens, alphas); head left to the
    caller (see :func:`factored_att_forward_hiddens`)."""
    b, t = captions.shape
    if rng is None:
        rng = jax.random.PRNGKey(0)
    k_drop, k_tf = jax.random.split(rng)

    emb_seq = jnp.take(params["embed"], captions, axis=0)
    if train and cfg.dropout > 0.0:
        keep = jax.random.bernoulli(k_drop, 1.0 - cfg.dropout, emb_seq.shape)
        emb_seq = jnp.where(keep, emb_seq / (1.0 - cfg.dropout), 0.0)

    att = params["attention"]
    att1 = features @ att["enc_w"] + att["enc_b"]
    h0, c0 = init_hidden_state(params, features)

    if (isinstance(teacher_forcing_ratio, float)
            and teacher_forcing_ratio >= 1.0):
        def tf_body(carry, emb_teacher):
            h, c = carry
            context, alpha = _gated_context_pre(params, att, att1, features, h)
            x = jnp.concatenate([emb_teacher, context], axis=-1)
            h, c = lstm_cell(params["cell"], x, h, c)
            return (h, c), (h, alpha)

        _, (hiddens, alphas) = jax.lax.scan(
            tf_body, (h0, c0), jnp.swapaxes(emb_seq, 0, 1))
        return jnp.swapaxes(hiddens, 0, 1), jnp.swapaxes(alphas, 0, 1)

    coins = jax.random.bernoulli(k_tf, teacher_forcing_ratio, (t,))

    def body(carry, xs):
        h, c, prev = carry
        emb_teacher, coin = xs
        context, alpha = _gated_context_pre(params, att, att1, features, h)
        e = jnp.where(coin, emb_teacher, jnp.take(params["embed"], prev, axis=0))
        x = jnp.concatenate([e, context], axis=-1)
        h, c = lstm_cell(params["cell"], x, h, c)
        logits = (jax.lax.stop_gradient(h) @ params["linear_w"]
                  + params["linear_b"])
        return (h, c, jnp.argmax(logits, axis=-1)), (h, alpha)

    _, (hiddens, alphas) = jax.lax.scan(
        body, (h0, c0, captions[:, 0]), (jnp.swapaxes(emb_seq, 0, 1), coins)
    )
    return jnp.swapaxes(hiddens, 0, 1), jnp.swapaxes(alphas, 0, 1)
