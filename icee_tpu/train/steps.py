"""Jitted training/validation steps for every family.

Each reference training loop (SURVEY.md T1-T6) iterates Python over batches
and timesteps; here every step — encoder head, decoder scan, masked loss,
gradient clamp, Adam update — is ONE jitted XLA program, compiled once per
regime.  Batches are fixed-shape (see data/pipeline.py) so there is exactly
one compilation.

Loss parity: targets are the un-shifted caption at step t for the non-
attention families (feature prepended as step-0 input,
``train_multitask.py:375-383``) and the shifted caption for attention and
seq2seq-emotion (input ``captions[:,:-1]``, target ``captions[:,1:]``,
lengths-1; ``train_multitask_att.py:308-311``, ``seq2seq/train.py:316-332``),
normalized by valid-token count like the packed ``CrossEntropyLoss``.

The doubly-stochastic attention regularizer ``alpha_c * mean((1-sum_t
alpha)^2)`` is added for attention variants (``train_multitask_att.py:
322-323``), with invalid timesteps contributing zero attention exactly like
the reference's preallocated ``alphas`` buffer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from icee_tpu.core.config import (
    AttentionDecoderConfig,
    DecoderConfig,
    Seq2SeqConfig,
    TrainConfig,
)
from icee_tpu.core import backend
from icee_tpu.evaluation.metrics import (
    length_mask,
    masked_cross_entropy,
    masked_top_k_accuracy,
)
from icee_tpu.models import attention as att_mod
from icee_tpu.models import encoder as enc_mod
from icee_tpu.ops.chunked_loss import masked_ce_from_hiddens
from icee_tpu.models import factored_lstm as fl
from icee_tpu.models import lstm as nic
from icee_tpu.models import seq2seq as s2s


class StepMetrics(NamedTuple):
    loss: jax.Array
    top5: jax.Array


def _val_metrics(logits, targets, lengths, sample_mask):
    return StepMetrics(
        loss=masked_cross_entropy(logits, targets, lengths, sample_mask),
        top5=masked_top_k_accuracy(logits, targets, lengths, 5, sample_mask),
    )


def _merge_bn_stats(updated_head, forward_head):
    """Keep optimizer-updated weights but the forward pass's BN running
    stats (running stats are state, not parameters)."""
    out = dict(updated_head)
    bn = dict(out["bn"])
    bn["running_mean"] = forward_head["bn"]["running_mean"]
    bn["running_var"] = forward_head["bn"]["running_var"]
    out["bn"] = bn
    return out


# --------------------------------------------------------------------------
# Global-encoder families: StyleNet FactoredLSTM and NIC
# --------------------------------------------------------------------------

def make_caption_steps(
    cfg: DecoderConfig,
    tcfg: TrainConfig,
    optimizer: optax.GradientTransformation,
    lang_optimizer: optax.GradientTransformation,
    factored: bool = True,
):
    """Steps for the non-attention captioners over cached pooled features.

    ``optimizer`` covers (decoder, encoder head) — the factual track;
    ``lang_optimizer`` covers the decoder only — the emotion track
    (``train_multitask.py:163-167``).

    The steps are plain jitted programs: under a data-parallel mesh GSPMD
    partitions them from the input shardings, so RNG draws match the
    single-device run (only cross-device reduction order differs).
    """
    use_chunked = backend.resolve_chunked_ce(tcfg.chunked_ce)
    fwd = (fl.forward if factored else
           lambda p, c, caps, feats, style, **kw: nic.forward(
               p, c, caps, feats, **kw))
    fwd_h = (fl.forward_hiddens if factored else
             lambda p, c, caps, feats, style, **kw: nic.forward_hiddens(
                 p, c, caps, feats, **kw))
    head_of = ((lambda d: (d["C_w"], d["C_b"])) if factored
               else (lambda d: (d["linear_w"], d["linear_b"])))

    def _forward(dec, head, pooled, captions, style, rng, train, tf_ratio):
        feats, new_head = enc_mod.encode_global_from_pooled(
            head, pooled, train=train
        )
        logits = fwd(dec, cfg, captions, feats, style=style,
                     teacher_forcing_ratio=tf_ratio, rng=rng, train=train)
        return logits, new_head

    def _train_loss(d, h, pooled, captions, lengths, sample_mask, style, rng):
        """Masked token-mean CE of the training forward; with chunked_ce the
        (B, T, V) logits never materialize (ops/chunked_loss.py)."""
        if not use_chunked:
            logits, new_head = _forward(
                d, h, pooled, captions, style, rng, True,
                tcfg.teacher_forcing_ratio)
            return masked_cross_entropy(
                logits, captions, lengths, sample_mask), new_head
        feats, new_head = enc_mod.encode_global_from_pooled(
            h, pooled, train=True)
        hiddens = fwd_h(d, cfg, captions, feats, style=style,
                        teacher_forcing_ratio=tcfg.teacher_forcing_ratio,
                        rng=rng, train=True)
        head_w, head_b = head_of(d)
        return masked_ce_from_hiddens(
            hiddens, head_w, head_b, captions, lengths, sample_mask), new_head

    @jax.jit
    def factual_train_step(dec, head, opt_state, pooled, captions, lengths,
                           sample_mask, rng):
        def loss_fn(trainable):
            d, h = trainable
            return _train_loss(d, h, pooled, captions, lengths, sample_mask,
                               jnp.asarray(0), rng)

        (loss, new_head), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            (dec, head)
        )
        updates, opt_state = optimizer.update(grads, opt_state, (dec, head))
        dec, head_upd = optax.apply_updates((dec, head), updates)
        head_upd = _merge_bn_stats(head_upd, new_head)
        return dec, head_upd, opt_state, loss

    @jax.jit
    def emotion_train_step(dec, head, opt_state, pooled, captions, lengths,
                           sample_mask, style, rng):
        def loss_fn(d):
            return _train_loss(d, head, pooled, captions, lengths,
                               sample_mask, style, rng)

        (loss, new_head), grads = jax.value_and_grad(loss_fn, has_aux=True)(dec)
        updates, opt_state = lang_optimizer.update(grads, opt_state, dec)
        dec = optax.apply_updates(dec, updates)
        head = _merge_bn_stats(head, new_head)
        return dec, head, opt_state, loss

    @jax.jit
    def val_step(dec, head, pooled, captions, lengths, sample_mask, style):
        # eval: teacher_forcing_ratio=0 (free-running), encoder head in eval
        # mode (train_multitask.py:272-299)
        logits, _ = _forward(dec, head, pooled, captions, style,
                             jax.random.PRNGKey(0), False, 0.0)
        m = _val_metrics(logits, captions, lengths, sample_mask)
        preds = jnp.argmax(logits, axis=-1)
        return m.loss, m.top5, preds

    return factual_train_step, emotion_train_step, val_step


# --------------------------------------------------------------------------
# Attention families (spatial features)
# --------------------------------------------------------------------------

def make_attention_steps(
    cfg: AttentionDecoderConfig,
    tcfg: TrainConfig,
    optimizer: optax.GradientTransformation,
    lang_optimizer: optax.GradientTransformation,
    factored: bool = True,
):
    """Steps for the attention captioners (spatial encoder has no trainable
    parameters, so both optimizers cover the decoder;
    ``train_multitask_att.py:165-166``).

    Inputs/targets are shifted: model consumes ``captions[:, :-1]`` and
    predicts ``captions[:, 1:]`` with lengths-1.
    """
    use_chunked = backend.resolve_chunked_ce(tcfg.chunked_ce)

    def _forward(dec, features, captions_in, style, rng, train, tf_ratio):
        if factored:
            return att_mod.factored_att_forward(
                dec, cfg, captions_in, features, style,
                teacher_forcing_ratio=tf_ratio, rng=rng, train=train)
        return att_mod.rnn_att_forward(
            dec, cfg, captions_in, features,
            teacher_forcing_ratio=tf_ratio, rng=rng, train=train)

    def _loss(dec, features, captions, lengths, sample_mask, style, rng,
              train, tf_ratio):
        captions_in = captions[:, :-1]
        targets = captions[:, 1:]
        tgt_len = jnp.maximum(lengths - 1, 0)
        logits, alphas = _forward(dec, features, captions_in, style, rng,
                                  train, tf_ratio)
        ce = masked_cross_entropy(logits, targets, tgt_len, sample_mask)
        # doubly-stochastic regularizer over valid steps only
        mask = length_mask(tgt_len, logits.shape[1]) & sample_mask[:, None]
        a = jnp.where(mask[..., None], alphas, 0.0)
        n_valid_rows = jnp.maximum(jnp.sum(sample_mask), 1)
        att_reg = jnp.sum((1.0 - jnp.sum(a, axis=1)) ** 2 * sample_mask[:, None]) / (
            n_valid_rows * alphas.shape[-1]
        )
        return ce + tcfg.alpha_c * att_reg, (logits, targets, tgt_len)

    def _att_reg(alphas, tgt_len, sample_mask):
        mask = length_mask(tgt_len, alphas.shape[1]) & sample_mask[:, None]
        a = jnp.where(mask[..., None], alphas, 0.0)
        n_valid_rows = jnp.maximum(jnp.sum(sample_mask), 1)
        return jnp.sum(
            (1.0 - jnp.sum(a, axis=1)) ** 2 * sample_mask[:, None]
        ) / (n_valid_rows * alphas.shape[-1])

    def _train_loss(dec, features, captions, lengths, sample_mask, style,
                    rng):
        """CE + doubly-stochastic regularizer; with chunked_ce the (B,T,V)
        logits never materialize (ops/chunked_loss.py)."""
        if not use_chunked:
            return _loss(dec, features, captions, lengths, sample_mask,
                         style, rng, True, tcfg.teacher_forcing_ratio)[0]
        captions_in = captions[:, :-1]
        targets = captions[:, 1:]
        tgt_len = jnp.maximum(lengths - 1, 0)
        if factored:
            hiddens, alphas = att_mod.factored_att_forward_hiddens(
                dec, cfg, captions_in, features, style,
                teacher_forcing_ratio=tcfg.teacher_forcing_ratio, rng=rng,
                train=True)
            head_w, head_b = dec["C_w"], dec["C_b"]
        else:
            hiddens, alphas = att_mod.rnn_att_forward_hiddens(
                dec, cfg, captions_in, features,
                teacher_forcing_ratio=tcfg.teacher_forcing_ratio, rng=rng,
                train=True)
            head_w, head_b = dec["linear_w"], dec["linear_b"]
        ce = masked_ce_from_hiddens(hiddens, head_w, head_b, targets,
                                    tgt_len, sample_mask)
        return ce + tcfg.alpha_c * _att_reg(alphas, tgt_len, sample_mask)

    @jax.jit
    def factual_train_step(dec, opt_state, features, captions, lengths,
                           sample_mask, rng):
        loss, grads = jax.value_and_grad(_train_loss)(
            dec, features, captions, lengths, sample_mask, jnp.asarray(0),
            rng)
        updates, opt_state = optimizer.update(grads, opt_state, dec)
        return optax.apply_updates(dec, updates), opt_state, loss

    @jax.jit
    def emotion_train_step(dec, opt_state, features, captions, lengths,
                           sample_mask, style, rng):
        loss, grads = jax.value_and_grad(_train_loss)(
            dec, features, captions, lengths, sample_mask, style, rng)
        updates, opt_state = lang_optimizer.update(grads, opt_state, dec)
        return optax.apply_updates(dec, updates), opt_state, loss

    @jax.jit
    def val_step(dec, features, captions, lengths, sample_mask, style):
        loss, (logits, targets, tgt_len) = _loss(
            dec, features, captions, lengths, sample_mask, style,
            jax.random.PRNGKey(0), False, 0.0)
        top5 = masked_top_k_accuracy(logits, targets, tgt_len, 5, sample_mask)
        preds = jnp.argmax(logits, axis=-1)
        return loss, top5, preds

    return factual_train_step, emotion_train_step, val_step


# --------------------------------------------------------------------------
# Seq2seq style transfer
# --------------------------------------------------------------------------

def make_seq2seq_steps(
    cfg: Seq2SeqConfig,
    tcfg: TrainConfig,
    optimizer: optax.GradientTransformation,
    emotion_optimizer: optax.GradientTransformation,
):
    """T6 steps.  ``optimizer`` covers (encoder-half, encoder head);
    ``emotion_optimizer`` covers the stacked emotion decoders with a
    per-emotion slice mask applied at call time (reference keeps one Adam per
    emotion decoder, ``seq2seq/train.py:141-158``)."""
    use_chunked = backend.resolve_chunked_ce(tcfg.chunked_ce)

    @jax.jit
    def factual_train_step(params, head, opt_state, pooled, captions, lengths,
                           sample_mask, rng):
        def loss_fn(trainable):
            enc_half, h = trainable
            feats, new_head = enc_mod.encode_global_from_pooled(h, pooled, True)
            p = dict(params)
            p["encoder"] = enc_half
            if use_chunked:
                hiddens, _ = s2s.encode(p, cfg, feats, captions,
                                        tcfg.teacher_forcing_ratio, rng, True,
                                        return_hiddens=True)
                return masked_ce_from_hiddens(
                    hiddens, enc_half["linear_w"], enc_half["linear_b"],
                    captions, lengths, sample_mask), new_head
            logits, _ = s2s.encode(p, cfg, feats, captions,
                                   tcfg.teacher_forcing_ratio, rng, True)
            return masked_cross_entropy(logits, captions, lengths,
                                        sample_mask), new_head

        (loss, new_head), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            (params["encoder"], head))
        updates, opt_state = optimizer.update(
            grads, opt_state, (params["encoder"], head))
        enc_half, head_upd = optax.apply_updates((params["encoder"], head),
                                                 updates)
        head_upd = _merge_bn_stats(head_upd, new_head)
        new_params = dict(params)
        new_params["encoder"] = enc_half
        return new_params, head_upd, opt_state, loss

    @jax.jit
    def emotion_train_step(params, head, opt_state, pooled, captions_src,
                           src_lengths, captions_dst, dst_lengths, sample_mask,
                           emotion, rng):
        def loss_fn(decoders):
            p = dict(params)
            p["decoders"] = decoders
            feats, _ = enc_mod.encode_global_from_pooled(head, pooled, True)
            if use_chunked:
                # same rng split as s2s.forward; the encoder pass is skipped
                # outright — the reference's DecoderRNN.forward zeroes its
                # state (seq2seq/model.py:168-176), so the encoder output is
                # dead in the emotion loss (XLA DCEs it on the s2s.forward
                # path; here we just don't build it)
                _k_enc, k_dec = jax.random.split(rng)
                hiddens = s2s.decode_emotion(
                    p, cfg, None, captions_dst[:, :-1], emotion,
                    tcfg.teacher_forcing_ratio, k_dec, True,
                    return_hiddens=True)
                half = s2s.select_decoder(p, emotion)
                return masked_ce_from_hiddens(
                    hiddens, half["linear_w"], half["linear_b"],
                    captions_dst[:, 1:], jnp.maximum(dst_lengths - 1, 0),
                    sample_mask)
            logits = s2s.forward(
                p, cfg, feats, (captions_src, src_lengths),
                (captions_dst[:, :-1], dst_lengths - 1), emotion,
                tcfg.teacher_forcing_ratio, rng, True)
            return masked_cross_entropy(
                logits, captions_dst[:, 1:], jnp.maximum(dst_lengths - 1, 0),
                sample_mask)

        loss, grads = jax.value_and_grad(loss_fn)(params["decoders"])
        # zero other emotions' slices so each emotion keeps its own moments
        onehot = jax.nn.one_hot(emotion, 3)
        grads = jax.tree_util.tree_map(
            lambda g: g * onehot.reshape((3,) + (1,) * (g.ndim - 1)).astype(g.dtype),
            grads)
        updates, opt_state = emotion_optimizer.update(
            grads, opt_state, params["decoders"])
        new_params = dict(params)
        new_params["decoders"] = optax.apply_updates(params["decoders"], updates)
        return new_params, opt_state, loss

    @jax.jit
    def val_factual_step(params, head, pooled, captions, lengths, sample_mask):
        feats, _ = enc_mod.encode_global_from_pooled(head, pooled, False)
        logits, _ = s2s.encode(params, cfg, feats, captions, 0.0,
                               jax.random.PRNGKey(0), False)
        m = _val_metrics(logits, captions, lengths, sample_mask)
        return m.loss, m.top5, jnp.argmax(logits, axis=-1)

    @jax.jit
    def val_emotion_step(params, head, pooled, captions_src, src_lengths,
                         captions_dst, dst_lengths, sample_mask, emotion):
        feats, _ = enc_mod.encode_global_from_pooled(head, pooled, False)
        logits = s2s.forward(
            params, cfg, feats, (captions_src, src_lengths),
            (captions_dst[:, :-1], dst_lengths - 1), emotion, 0.0,
            jax.random.PRNGKey(0), False)
        tgt_len = jnp.maximum(dst_lengths - 1, 0)
        m = _val_metrics(logits, captions_dst[:, 1:], tgt_len, sample_mask)
        return m.loss, m.top5, jnp.argmax(logits, axis=-1)

    return factual_train_step, emotion_train_step, val_factual_step, val_emotion_step
