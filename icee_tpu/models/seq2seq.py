"""Seq2seq style-transfer family in JAX.

Parity target: ``EncoderRNN`` / ``DecoderRNN`` / ``Seq2Seq``
(``seq2seq/model.py:30-301``, SURVEY.md M8): an LSTM encoder over the factual
caption prefixed by the image feature, and one decoder LSTM per emotion.  The
encoder's final (h, c) reaches the emotion decoders only at SAMPLE time —
the reference's ``DecoderRNN.forward`` takes the states argument but zeroes
its own h/c (``model.py:168-176``), a quirk this rebuild reproduces.

Design: the three per-emotion decoders are one stacked parameter set
``(3, ...)`` selected by a traced emotion id, so a single compiled graph
serves happy/sad/angry; both encoder and decoder time loops are ``lax.scan``.

Init parity: this family never calls a reset, so parameters keep torch
defaults — ``nn.Embedding`` ~ N(0,1), ``nn.LSTM``/``nn.Linear`` ~
U(-1/sqrt(fan)).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from icee_tpu.core.config import Seq2SeqConfig
from icee_tpu.core import initializers as init
from icee_tpu.models.lstm import (
    init_multilayer,
    multilayer_initial_state,
)
from icee_tpu.ops.cells import multilayer_lstm_cell

State = Tuple[jax.Array, jax.Array]  # (num_layers, B, H) each


def _init_half(key: jax.Array, cfg: Seq2SeqConfig, dtype) -> dict:
    """One encoder-or-decoder parameter set (embed + LSTM stack + head)."""
    k_emb, k_lstm, k_lin_w, k_lin_b = jax.random.split(key, 4)
    e, h, v = cfg.embed_size, cfg.hidden_size, cfg.vocab_size
    return {
        "embed": jax.random.normal(k_emb, (v, e), dtype),
        "lstm": init_multilayer(k_lstm, e, h, cfg.num_layers, dtype, xavier=False),
        "linear_w": init.torch_linear_default(k_lin_w, (h, v), h, dtype),
        "linear_b": init.torch_linear_default(k_lin_b, (v,), h, dtype),
    }


def init_params(key: jax.Array, cfg: Seq2SeqConfig, dtype=jnp.float32) -> dict:
    k_enc, k_dec = jax.random.split(key)
    dec_keys = jax.random.split(k_dec, 3)  # happy, sad, angry
    decoders = [_init_half(k, cfg, dtype) for k in dec_keys]
    return {
        "encoder": _init_half(k_enc, cfg, dtype),
        # stacked emotion decoders, axis 0 = (happy, sad, angry)
        "decoders": jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *decoders),
    }


def select_decoder(params: dict, emotion: jax.Array) -> dict:
    """Emotion id (0=happy, 1=sad, 2=angry) -> that decoder's parameters."""
    return jax.tree_util.tree_map(
        lambda x: jnp.take(x, emotion, axis=0), params["decoders"]
    )


def _scheduled_rnn(
    half: dict,
    cfg: Seq2SeqConfig,
    tokens: jax.Array,                 # (B, T)
    prefix: Optional[jax.Array],       # (B, E) feature or None
    state: Optional[State],
    teacher_forcing_ratio: float,
    rng: jax.Array,
    train: bool,
    return_hiddens: bool = False,
) -> Tuple[jax.Array, State]:
    """Shared teacher-forced loop (``seq2seq/model.py:68-98,162-191``).

    With ``return_hiddens`` the scan emits the top-layer hidden states
    (B, T, H) instead of logits, for the chunked training loss
    (``ops/chunked_loss.py``); the head still runs per step to pick the
    argmax feedback token (no gradient; never stacked)."""
    b, t = tokens.shape
    k_drop, k_tf = jax.random.split(rng)
    emb = jnp.take(half["embed"], tokens, axis=0)
    if train and cfg.dropout > 0.0:
        keep = jax.random.bernoulli(k_drop, 1.0 - cfg.dropout, emb.shape)
        emb = jnp.where(keep, emb / (1.0 - cfg.dropout), 0.0)

    if prefix is not None:
        teacher_inputs = jnp.concatenate(
            [prefix[:, None, :].astype(emb.dtype), emb[:, :-1]], axis=1
        )
    else:
        teacher_inputs = emb

    coins = jax.random.bernoulli(k_tf, teacher_forcing_ratio, (t,))
    if state is None:
        state = multilayer_initial_state(cfg.num_layers, b, cfg.hidden_size, emb.dtype)

    # nn.LSTM params as a per-layer list view over possibly stacked tensors
    layers = half["lstm"]

    def body(carry, xs):
        h, c, prev = carry
        x_teacher, coin = xs
        x = jnp.where(coin, x_teacher, jnp.take(half["embed"], prev, axis=0))
        top, h, c = multilayer_lstm_cell(layers, x, h, c)
        head_in = jax.lax.stop_gradient(top) if return_hiddens else top
        logits = head_in @ half["linear_w"] + half["linear_b"]
        out = top if return_hiddens else logits
        return (h, c, jnp.argmax(logits, axis=-1)), out

    (h, c, _), outs = jax.lax.scan(
        body, (state[0], state[1], tokens[:, 0]),
        (jnp.swapaxes(teacher_inputs, 0, 1), coins),
    )
    return jnp.swapaxes(outs, 0, 1), (h, c)


def encode(
    params: dict,
    cfg: Seq2SeqConfig,
    features: jax.Array,
    src_tokens: jax.Array,
    teacher_forcing_ratio: float = 0.5,
    rng: Optional[jax.Array] = None,
    train: bool = True,
    return_hiddens: bool = False,
) -> Tuple[jax.Array, State]:
    """EncoderRNN.forward: feature-prefixed autoencoding pass
    (``seq2seq/model.py:68-98``)."""
    if rng is None:
        rng = jax.random.PRNGKey(0)
    return _scheduled_rnn(
        params["encoder"], cfg, src_tokens, features, None,
        teacher_forcing_ratio, rng, train, return_hiddens,
    )


def decode_emotion(
    params: dict,
    cfg: Seq2SeqConfig,
    state: State,
    dst_tokens: jax.Array,
    emotion: jax.Array | int,
    teacher_forcing_ratio: float = 0.5,
    rng: Optional[jax.Array] = None,
    train: bool = True,
    return_hiddens: bool = False,
) -> jax.Array:
    """Per-emotion DecoderRNN.forward (``seq2seq/model.py:162-191``).

    Reference quirk preserved: ``DecoderRNN.forward`` accepts the encoder's
    final ``states`` but never reads them — it builds fresh zero h/c
    (``seq2seq/model.py:168-176``), so the emotion decoder TRAINS from a zero
    state and only ``sample`` threads the encoder state.  ``state`` is kept
    in the signature for parity with the reference call shape, and ignored
    exactly like the reference does.  Verified against the reference's own
    module in ``tests/test_reference_modules.py``.
    """
    del state  # dead in the reference's training forward (model.py:168-176)
    if rng is None:
        rng = jax.random.PRNGKey(0)
    half = select_decoder(params, jnp.asarray(emotion))
    out, _ = _scheduled_rnn(
        half, cfg, dst_tokens, None, None, teacher_forcing_ratio, rng, train,
        return_hiddens,
    )
    return out


def forward(
    params: dict,
    cfg: Seq2SeqConfig,
    features: jax.Array,
    src: Tuple[jax.Array, jax.Array],
    dst: Optional[Tuple[jax.Array, jax.Array]] = None,
    emotion: Optional[jax.Array | int] = None,
    teacher_forcing_ratio: float = 0.8,
    rng: Optional[jax.Array] = None,
    train: bool = True,
):
    """Seq2Seq.forward (``seq2seq/model.py:256-283``): factual mode returns
    the encoder logits; emotion modes continue with that emotion's decoder."""
    if rng is None:
        rng = jax.random.PRNGKey(0)
    k_enc, k_dec = jax.random.split(rng)
    src_tokens, _src_len = src
    enc_logits, state = encode(
        params, cfg, features, src_tokens, teacher_forcing_ratio, k_enc, train
    )
    if emotion is None:
        return enc_logits
    dst_tokens, _dst_len = dst
    return decode_emotion(
        params, cfg, state, dst_tokens, emotion, teacher_forcing_ratio, k_dec, train
    )


def greedy_sample(
    params: dict,
    cfg: Seq2SeqConfig,
    features: jax.Array,
    start_token: int,
    emotion: Optional[jax.Array | int] = None,
) -> jax.Array:
    """Seq2Seq.sample (``seq2seq/model.py:285-301``): greedy encoder rollout
    from the image feature; for emotion modes, continue greedily with that
    emotion's decoder from the encoder's final state.  Returns (B, L) ids."""
    b = features.shape[0]
    enc = params["encoder"]

    def rollout(half, first_input_emb, state):
        def body(carry, _):
            h, c, x = carry
            top, h, c = multilayer_lstm_cell(half["lstm"], x, h, c)
            logits = top @ half["linear_w"] + half["linear_b"]
            pred = jnp.argmax(logits, axis=-1)
            return (h, c, jnp.take(half["embed"], pred, axis=0)), pred

        (h, c, _), preds = jax.lax.scan(
            body, (state[0], state[1], first_input_emb), None,
            length=cfg.max_seq_length,
        )
        return jnp.swapaxes(preds, 0, 1), (h, c)

    state0 = multilayer_initial_state(cfg.num_layers, b, cfg.hidden_size,
                                      features.dtype)
    enc_ids, enc_state = rollout(enc, features, state0)

    if emotion is None:
        return enc_ids

    # Reference quirk preserved: the emotion decoder continues from the
    # encoder's *greedy rollout* final state (Seq2Seq.sample's states
    # threading, seq2seq/model.py:285-301).
    half = select_decoder(params, jnp.asarray(emotion))
    start = jnp.full((b,), start_token, jnp.int32)
    ids, _ = rollout(half, jnp.take(half["embed"], start, axis=0), enc_state)
    return ids
