"""Base multimodal RNN (mRNN) language/caption model in JAX.

Parity target: the Theano ``RNNModel`` (``senticap/mrnn/mrnn.py``,
SURVEY.md C2).  The symbolic ``theano.scan`` graphs become ``lax.scan``;
the reference's device-resident shared-variable dataset becomes device-
resident jnp arrays gathered by index inside the jitted step
(SURVEY.md §2.5 "device-resident dataset").

Numerics preserved exactly:

- one fused recurrent matmul: ``[x_t ; clip(h)] @ w_lstm`` split into
  [i, f, o, cell] gate slices (``mrnn.py:416-433``) with ``hh = og * cc``
  — again NO tanh on the cell (``:433``),
- image injected as the step-0 pseudo-word ``v @ wvm + bmv``
  (``:390-391``); words shift in from step 1,
- the gradient-clip-on-activations op ``clipg`` (``mrnn_util.py:78-98``)
  clips the *backward* signal of ``h`` to +/-GRAD_CLIP_SIZE; forward is
  identity — implemented with ``jax.custom_vjp``,
- loss = SUM of per-token categorical cross-entropy weighted by the mask
  (``mrnn.py:544-567``), NOT a mean,
- perplexity ``2 ** (sum(-log2 p) / sum(len))`` with the +1e-20 fudge
  (``:518-530``),
- output bias initialized to the log unigram distribution (``:347-362``),
- dropout via precomputed masks on input embeddings and hidden output
  (``:71-76`` mask maker semantics).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from icee_tpu.senticap.config import senticap_conf


# --- grad-clip-on-activation op (mrnn_util.py GradClip) -------------------

@jax.custom_vjp
def grad_clip_act(x: jax.Array, bound: float) -> jax.Array:
    return x


def _gca_fwd(x, bound):
    return x, bound


def _gca_bwd(bound, g):
    return jnp.clip(g, -bound, bound), None


grad_clip_act.defvjp(_gca_fwd, _gca_bwd)


def chunked_ce_requested(conf: dict) -> bool:
    """Resolution of ``conf["CHUNKED_CE"]`` (None = the backend's choice,
    ``core/backend.py``); SOFTMAX_OUT-guarded by the callers that need it."""
    from icee_tpu.core import backend

    return backend.resolve_chunked_ce(conf.get("CHUNKED_CE"))


# --- parameters -----------------------------------------------------------

def init_params(key: jax.Array, vocab_size: int, conf=None,
                unigram: Optional[np.ndarray] = None,
                dtype=jnp.float32) -> dict:
    """Xavier-style init matching ``mrnn_util.py:46-70`` (uniform
    +/- sqrt(6/(fan_in+fan_out))); output bias = log unigram probs."""
    conf = conf or senticap_conf()
    e, h, v = conf["emb_size"], conf["lstm_hidden_size"], vocab_size
    vis = conf["visual_size"]

    def xav(k, shape):
        a = np.sqrt(6.0 / (shape[0] + shape[1]))
        return jax.random.uniform(k, shape, dtype, minval=-a, maxval=a)

    ks = jax.random.split(key, 5)
    if unigram is not None:
        b = jnp.asarray(np.log(unigram + 1e-20), dtype)
    else:
        b = jnp.full((v,), -np.log(v), dtype)
    params = {
        "wemb": xav(ks[0], (v, e)),
        "w_lstm": xav(ks[1], (e + h, 4 * h)),
        "w": xav(ks[2], (h, v)),
        "b": b,
        "wvm": xav(ks[3], (vis, e)),
        "bmv": jnp.zeros((e,), dtype),
    }
    if conf.get("BATCH_NORM"):
        # gamma/beta over the [x_t ; h] input state (``mrnn.py:293-300``
        # sizes them lstm_hidden_size*2, assuming emb_size == hidden);
        # ones/zeros init, saveable + trainable like the reference
        params["gamma_h"] = jnp.ones((e + h,), dtype)
        params["beta_h"] = jnp.zeros((e + h,), dtype)
    return params


# --- cell -----------------------------------------------------------------

def cell(params: dict, x_t: jax.Array, h: jax.Array, c: jax.Array,
         grad_clip: float = 5.0, batch_norm: bool = False
         ) -> Tuple[jax.Array, jax.Array]:
    """One recurrence (``mrnn.py:404-440``): fused [x;h] matmul, gate order
    [i, f, o, cellcand], ``hh = og * cc``.

    ``batch_norm`` reproduces the reference's BATCH_NORM branch QUIRK
    (``mrnn.py:408-413``): it computes the batch mean/variance of the input
    state but then applies ``gamma_h * in_state + beta_h`` to the
    UN-normalized state — the normalization is dead code.  The applied math
    (the affine only) is reproduced; the no-effect mu/var computation is
    not re-executed.
    """
    hs = h.shape[-1]
    h_clip = grad_clip_act(h, grad_clip)
    in_state = jnp.concatenate([x_t, h_clip], axis=-1)
    if batch_norm:
        in_state = params["gamma_h"] * in_state + params["beta_h"]
    z = jnp.dot(in_state, params["w_lstm"], preferred_element_type=jnp.float32)
    ig = jax.nn.sigmoid(z[:, :hs])
    fg = jax.nn.sigmoid(z[:, hs:2 * hs])
    og = jax.nn.sigmoid(z[:, 2 * hs:3 * hs])
    cc = fg * c + ig * jnp.tanh(z[:, 3 * hs:])
    hh = og * cc  # reference quirk: no tanh (mrnn.py:433)
    return hh.astype(h.dtype), cc.astype(c.dtype)


def output_probs(params: dict, hh: jax.Array,
                 softmax_out: bool = True) -> jax.Array:
    """Word distribution (``mrnn.py:438-443``): softmax normally; the
    joined model sets ``SOFTMAX_OUT=False`` and emits elementwise sigmoid
    instead (its outputs are switch gates, not a distribution)."""
    logits = hh @ params["w"] + params["b"]
    if softmax_out:
        return jax.nn.softmax(logits, axis=-1)
    return jax.nn.sigmoid(logits)


def visual_embedding(params: dict, v: jax.Array) -> jax.Array:
    """Image as pseudo-word: ``v @ wvm + bmv`` (``mrnn.py:390-391``)."""
    return v @ params["wvm"] + params["bmv"]


def _check_conf(conf: dict) -> None:
    """Refuse silently-ignorable conf branches.

    ``JOINED_LOSS_FUNCTION`` is only meaningful for the joined switched
    model (``mrnn.py:111-115`` ``set_as_joined_model``): the base mRNN has
    no (mm, lm) pair to mix, so setting it here is an error rather than a
    silent no-op.  The joined mixture loss lives in
    :func:`icee_tpu.senticap.switched.switched_loss`.
    """
    if conf.get("JOINED_LOSS_FUNCTION"):
        raise NotImplementedError(
            "JOINED_LOSS_FUNCTION applies to the joined switched model; "
            "use icee_tpu.senticap.switched (switched_loss implements the "
            "switch-mixed cross-entropy of mrnn.py:540-560)")


# --- forward scans --------------------------------------------------------

def forward(
    params: dict,
    conf: dict,
    words: jax.Array,          # (B, T) int32 — input tokens, T = MAX_LEN+1
    v: jax.Array,              # (B, visual) image features (zeros for LM-only)
    use_visual: bool = True,
    x_drop: Optional[jax.Array] = None,   # (B, T, E) input dropout masks
    y_drop: Optional[jax.Array] = None,   # (B, T, H) output dropout masks
    return_hiddens: bool = False,
) -> jax.Array:
    """Teacher-forced scan -> word distributions (B, T, V).

    Step 0 consumes the visual pseudo-word when ``use_visual`` (the
    ``use_visual_info`` sequence, ``mrnn.py:478-494``); step t>=1 consumes
    ``words[:, t]`` (already arranged by the data layer: START, w1, ...).

    With ``return_hiddens`` the scan emits the (post-output-dropout) hidden
    states (B, T, H) instead; the chunked loss
    (:func:`icee_tpu.ops.chunked_loss.masked_sum_ce_from_hiddens` via
    :func:`loss_fn_from_hiddens`) applies the head so the (B, T, V)
    distributions never materialize.  Requires ``SOFTMAX_OUT`` (the caller
    guards).
    """
    _check_conf(conf)
    b, t = words.shape
    h_dim = conf["lstm_hidden_size"]
    gclip = conf["GRAD_CLIP_SIZE"]
    bn = conf.get("BATCH_NORM", False)

    emb = jnp.take(params["wemb"], words, axis=0)           # (B, T, E)
    vis = visual_embedding(params, v)                        # (B, E)
    use_v = jnp.arange(t) == 0 if use_visual else jnp.zeros((t,), bool)
    if x_drop is None:
        x_drop = jnp.ones_like(emb)
    if y_drop is None:
        y_drop = jnp.ones((b, t, h_dim), emb.dtype)

    def body(carry, xs):
        h, c = carry
        emb_t, xd, yd, uv = xs
        x_t = jnp.where(uv, vis, emb_t)
        if conf["DROP_INPUT"]:
            x_t = x_t * xd
        h, c = cell(params, x_t, h, c, gclip, bn)
        hh = h * yd if conf["DROP_OUTPUT"] else h
        if return_hiddens:
            return (h, c), hh
        s_t = output_probs(params, hh, conf.get("SOFTMAX_OUT", True))
        return (h, c), s_t

    h0 = jnp.zeros((b, h_dim), emb.dtype)
    c0 = jnp.zeros((b, h_dim), emb.dtype)
    (_, _), s = jax.lax.scan(
        body, (h0, c0),
        (jnp.swapaxes(emb, 0, 1), jnp.swapaxes(x_drop, 0, 1),
         jnp.swapaxes(y_drop, 0, 1), use_v))
    return jnp.swapaxes(s, 0, 1)  # (B, T, V)


def forward_semi_forced(
    params: dict,
    conf: dict,
    words: jax.Array,          # (B, T) teacher tokens
    v: jax.Array,              # (B, visual)
    forced: jax.Array,         # (B, T) 1 = feed ground truth, 0 = feed own argmax
    x_drop: Optional[jax.Array] = None,
    y_drop: Optional[jax.Array] = None,
    return_hiddens: bool = False,
) -> jax.Array:
    """Semi-forced scan (``recurrance_partial_word_feedback``,
    ``mrnn.py:442-476,496-503``): per-(sample, step) the input is either the
    teacher token or the model's own previous argmax, per the ``forced``
    matrix.  Used when ``conf['SEMI_FORCED'] < 1`` (the forced matrix is
    drawn Bernoulli(SEMI_FORCED) by the trainer)."""
    _check_conf(conf)
    b, t = words.shape
    h_dim = conf["lstm_hidden_size"]
    gclip = conf["GRAD_CLIP_SIZE"]
    bn = conf.get("BATCH_NORM", False)
    vis = visual_embedding(params, v)
    if x_drop is None:
        x_drop = jnp.ones((b, t, conf["emb_size"]))
    if y_drop is None:
        y_drop = jnp.ones((b, t, h_dim))
    use_v = jnp.arange(t) == 0

    def body(carry, xs):
        h, c, prev = carry
        w_t, xd, yd, f_t, uv = xs
        tok = jnp.where(f_t > 0, w_t, prev)
        x_t = jnp.where(uv, vis, jnp.take(params["wemb"], tok, axis=0))
        if conf["DROP_INPUT"]:
            x_t = x_t * xd
        h, c = cell(params, x_t, h, c, gclip, bn)
        hh = h * yd if conf["DROP_OUTPUT"] else h
        if return_hiddens:
            # argmax feedback from transient logits (same argmax as the
            # softmax probs; no gradient, never stacked)
            logits = (jax.lax.stop_gradient(hh) @ params["w"] + params["b"])
            prev = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            return (h, c, prev), hh
        s_t = output_probs(params, hh, conf.get("SOFTMAX_OUT", True))
        prev = jnp.argmax(s_t, axis=-1).astype(jnp.int32)
        return (h, c, prev), s_t

    h0 = jnp.zeros((b, h_dim))
    (_, _, _), s = jax.lax.scan(
        body, (h0, h0, jnp.zeros((b,), jnp.int32)),
        (jnp.swapaxes(words, 0, 1), jnp.swapaxes(x_drop, 0, 1),
         jnp.swapaxes(y_drop, 0, 1), jnp.swapaxes(forced, 0, 1), use_v))
    return jnp.swapaxes(s, 0, 1)


def loss_fn(s: jax.Array, y: jax.Array, mask: jax.Array) -> jax.Array:
    """SUM of masked categorical cross-entropy (``mrnn.py:560-567``).
    ``s``: (B, T, V) probabilities, ``y``: (B, T) targets, ``mask``: (B, T)."""
    p = jnp.take_along_axis(s, y[..., None], axis=-1)[..., 0]
    nll = -jnp.log(jnp.maximum(p, 1e-37))
    return jnp.sum(nll * mask)


# -log of the reference's probability floor (mrnn.py:563): the chunked loss
# realizes ``-log(max(p, 1e-37))`` as ``min(lse - tgt_logit, CLAMP)`` with
# zero gradient where clamped, exactly like the materialized ``max``.
PROB_FLOOR_CLAMP = 85.19956545910916  # == -log(1e-37)


def loss_fn_from_hiddens(params: dict, hh: jax.Array, y: jax.Array,
                         mask: jax.Array) -> jax.Array:
    """Same loss as :func:`loss_fn` computed from the (post-dropout) hidden
    states in time chunks — the (B, T, V) distributions never materialize
    (``icee_tpu.ops.chunked_loss``).  Only valid for ``SOFTMAX_OUT`` models
    (the joined model's sigmoid outputs are gates, not a distribution)."""
    from icee_tpu.ops.chunked_loss import masked_sum_ce_from_hiddens

    return masked_sum_ce_from_hiddens(hh, params["w"], params["b"], y, mask,
                                      clamp=PROB_FLOOR_CLAMP)


def perplexity(s: jax.Array, y: jax.Array, mask: jax.Array) -> jax.Array:
    """``2 ** (sum(-log2 p) / sum(len))`` with the 1e-20 fudge
    (``mrnn.py:518-530``)."""
    p = jnp.take_along_axis(s, y[..., None], axis=-1)[..., 0]
    hsum = -jnp.log2(p + 1e-20)
    return 2.0 ** (jnp.sum(hsum * mask) / jnp.sum(mask))


def one_step(params: dict, conf: dict, word: jax.Array, use_v: jax.Array,
             h: jax.Array, c: jax.Array, v: jax.Array):
    """Single decode step (the compiled ``one_step``, ``mrnn.py:532-546``):
    -> (s_t (B, V), h, c)."""
    emb = jnp.take(params["wemb"], word, axis=0)
    x_t = jnp.where(use_v[..., None], visual_embedding(params, v), emb)
    h, c = cell(params, x_t, h, c, conf["GRAD_CLIP_SIZE"],
                conf.get("BATCH_NORM", False))
    return output_probs(params, h, conf.get("SOFTMAX_OUT", True)), h, c


def greedy_sample(params: dict, conf: dict, v: jax.Array,
                  max_len: Optional[int] = None) -> jax.Array:
    """Free-running argmax rollout (``sample_sentence``, ``mrnn.py:837-871``)."""
    max_len = max_len or conf["MAX_SENTENCE_LEN"] + 1
    b = v.shape[0]
    h = jnp.zeros((b, conf["lstm_hidden_size"]))
    c = jnp.zeros_like(h)

    def body(carry, i):
        word, h, c = carry
        s_t, h, c = one_step(params, conf, word, i == 0, h, c, v)
        nxt = jnp.argmax(s_t, axis=-1).astype(jnp.int32)
        return (nxt, h, c), nxt

    (_, _, _), toks = jax.lax.scan(
        body, (jnp.zeros((b,), jnp.int32), h, c), jnp.arange(max_len))
    return jnp.swapaxes(toks, 0, 1)
