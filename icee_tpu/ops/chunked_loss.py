"""Chunked cross-entropy from hidden states — (B, T, V) logits never in HBM.

The reference training loss is ``CrossEntropyLoss()(logits, targets)`` over
the packed token stream (``stylenet/train_multitask.py:300``) computed from
fully materialized logits.  At production batch sizes that logits tensor
is large: at B=512, T=25, V=8192 it is 420 MB written by the forward,
re-read by the log-softmax, and re-read (plus its softmax residuals) by the
backward.

This module computes the *identical* masked token-mean CE directly from the
(B, T, H) hidden states in TIME chunks with a :func:`jax.custom_vjp`:

- forward: for each chunk of ``t_chunk`` timesteps, compute the (B, tc, V)
  logits, reduce to the chunk's logsumexp and target-logit
  contributions, discard the logits — only the (B, tc) logsumexp residuals
  are kept for the backward;
- backward: recompute each chunk's logits, form the softmax gradient in
  place (``p - onehot``, fused by XLA into the consuming matmuls), and
  accumulate dW/db/dx per chunk.

Grads match the materialized loss to <=2e-7 max|diff| (tested).  Whether
it is on by default is the backend's choice (``core/backend.py``), from the
on/off A/B of the train step on the card (PERF.md).

Chunking along TIME (not flat rows) keeps the batch dimension intact, so
the data-parallel trainers shard it over the mesh's data axis with no
resharding, and the head's vocab dimension stays free for tensor-parallel
GSPMD propagation (the logsumexp's vocab reduction turns into the same
model-axis collective the materialized log-softmax needs).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp


def auto_t_chunk(batch: int, t: int, target_rows: int = 2048) -> int:
    """Timesteps per chunk so that ``batch * t_chunk`` ~ ``target_rows``
    (the probe's sweet spot; smaller chunks re-read the head more often,
    larger ones re-grow the logits working set)."""
    return max(1, min(t, -(-target_rows // max(batch, 1))))


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6))
def _weighted_ce(hiddens, head_w, head_b, targets, weights, t_chunk,
                 clamp=None):
    """sum(weights * nll) with nll = lse - tgt_logit, optionally clamped to
    ``min(nll, clamp)`` — the SentiCap ``-log(max(p, 1e-37))`` quirk
    (``senticap/mrnn/mrnn.py:560-567``); clamped positions get zero
    gradient, exactly like the materialized ``max``."""
    loss, _ = _ce_forward(hiddens, head_w, head_b, targets, weights, t_chunk,
                          clamp)
    return loss


def _to_chunks(x, t_chunk):
    """(B, T, ...) -> (n_chunks, B, t_chunk, ...), zero-padding T."""
    b, t = x.shape[:2]
    pad = (-t) % t_chunk
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad)) + ((0, 0),) * (x.ndim - 2))
    x = x.reshape((b, -1, t_chunk) + x.shape[2:])
    return jnp.moveaxis(x, 1, 0)


def _ce_forward(hiddens, head_w, head_b, targets, weights, t_chunk,
                clamp=None):
    v = head_w.shape[-1]
    xc = _to_chunks(hiddens, t_chunk)
    tc = _to_chunks(targets, t_chunk)
    wc = _to_chunks(weights, t_chunk)

    def body(acc, xs):
        x, tt, ww = xs
        logits = (x @ head_w + head_b).astype(jnp.float32)  # (B, tc, V)
        m = jnp.max(logits, axis=-1)
        lse = m + jnp.log(jnp.sum(jnp.exp(logits - m[..., None]), axis=-1))
        # padded timesteps carry zero weight, so their (token-0) target
        # contribution vanishes
        tgt = jnp.sum(
            logits * jax.nn.one_hot(tt, v, dtype=logits.dtype), axis=-1)
        nll = lse - tgt
        if clamp is not None:
            nll = jnp.minimum(nll, jnp.float32(clamp))
        return acc + jnp.sum(ww * nll), lse

    loss, lses = jax.lax.scan(
        body, jnp.asarray(0.0, jnp.float32), (xc, tc, wc))
    return loss, lses


def _ce_fwd(hiddens, head_w, head_b, targets, weights, t_chunk, clamp=None):
    loss, lses = _ce_forward(hiddens, head_w, head_b, targets, weights,
                             t_chunk, clamp)
    return loss, (hiddens, head_w, head_b, targets, weights, lses)


def _ce_bwd(t_chunk, clamp, res, g):
    hiddens, head_w, head_b, targets, weights, lses = res
    b, t = targets.shape
    v = head_w.shape[-1]
    xc = _to_chunks(hiddens, t_chunk)
    tc = _to_chunks(targets, t_chunk)
    wc = _to_chunks(weights, t_chunk)
    w32 = head_w.astype(jnp.float32)

    def body(carry, xs):
        d_w, d_b = carry
        x, tt, ww, lse = xs
        logits = (x @ head_w + head_b).astype(jnp.float32)
        p = jnp.exp(logits - lse[..., None])
        dl = (p - jax.nn.one_hot(tt, v, dtype=jnp.float32))
        scale = ww * g
        if clamp is not None:
            tgt = jnp.sum(
                logits * jax.nn.one_hot(tt, v, dtype=logits.dtype), axis=-1)
            scale = scale * (lse - tgt < jnp.float32(clamp))
        dl = dl * scale[..., None]                           # (B, tc, V)
        dx = jnp.einsum("btv,hv->bth", dl, w32).astype(x.dtype)
        d_w = d_w + jnp.einsum("bth,btv->hv", x.astype(jnp.float32), dl)
        d_b = d_b + jnp.sum(dl, axis=(0, 1))
        return (d_w, d_b), dx

    (d_w, d_b), dxc = jax.lax.scan(
        body,
        (jnp.zeros(head_w.shape, jnp.float32),
         jnp.zeros(head_b.shape, jnp.float32)),
        (xc, tc, wc, lses))
    dx = jnp.moveaxis(dxc, 0, 1).reshape(b, -1, hiddens.shape[-1])[:, :t]
    return (dx, d_w.astype(head_w.dtype), d_b.astype(head_b.dtype),
            None, None)


_weighted_ce.defvjp(_ce_fwd, _ce_bwd)


def masked_ce_from_hiddens(
    hiddens: jax.Array,            # (B, T, H)
    head_w: jax.Array,             # (H, V)
    head_b: jax.Array,             # (V,)
    targets: jax.Array,            # (B, T) int
    lengths: jax.Array,            # (B,)
    sample_mask: Optional[jax.Array] = None,  # (B,) bool
    t_chunk: Optional[int] = None,
) -> jax.Array:
    """Token-mean masked CE, numerically equal to
    ``masked_cross_entropy(hiddens @ head_w + head_b, ...)``
    (``evaluation/metrics.py``) without materializing the logits."""
    b, t = targets.shape
    mask = jnp.arange(t)[None, :] < lengths[:, None]
    if sample_mask is not None:
        mask = mask & sample_mask[:, None]
    denom = jnp.maximum(jnp.sum(mask), 1)
    weights = mask.astype(jnp.float32) / denom
    if t_chunk is None:
        t_chunk = auto_t_chunk(b, t)
    return _weighted_ce(hiddens, head_w, head_b, targets, weights, t_chunk)


def masked_neglog2_sum_from_hiddens(
    hiddens: jax.Array,      # (B, T, H)
    head_w: jax.Array,       # (H, V)
    head_b: jax.Array,       # (V,)
    targets: jax.Array,      # (B, T) int
    mask: jax.Array,         # (B, T)
    t_chunk: Optional[int] = None,
) -> jax.Array:
    """``sum(mask * -log2(softmax(hh @ W + b)[y] + 1e-20))`` — the
    perplexity numerator (``mrnn.py:518-530``) without materializing the
    (B, T, V) distributions.  Value-only (eval path)."""
    b, t = targets.shape
    v = head_w.shape[-1]
    if t_chunk is None:
        t_chunk = auto_t_chunk(b, t)
    xc = _to_chunks(hiddens, t_chunk)
    tc = _to_chunks(targets, t_chunk)
    wc = _to_chunks(mask.astype(jnp.float32), t_chunk)

    def body(acc, xs):
        x, tt, ww = xs
        lse, tgt = _head_chunk(x, head_w, head_b, tt, v)
        p = jnp.exp(tgt - lse)
        return acc + jnp.sum(ww * -jnp.log2(p + 1e-20)), None

    acc, _ = jax.lax.scan(body, jnp.asarray(0.0, jnp.float32), (xc, tc, wc))
    return acc


def mixture_neglog2_sum_from_hiddens(
    hh_o: jax.Array, hh_n: jax.Array,
    co: jax.Array, cn: jax.Array,
    w_o: jax.Array, b_o: jax.Array,
    w_n: jax.Array, b_n: jax.Array,
    targets: jax.Array,
    mask: jax.Array,
    t_chunk: Optional[int] = None,
) -> jax.Array:
    """Two-head mixture form of :func:`masked_neglog2_sum_from_hiddens`
    (the switched model's perplexity numerator).  Value-only."""
    b, t = targets.shape
    v = w_o.shape[-1]
    if t_chunk is None:
        t_chunk = auto_t_chunk(b, t)
    xo = _to_chunks(hh_o, t_chunk)
    xn = _to_chunks(hh_n, t_chunk)
    coc = _to_chunks(co.astype(jnp.float32), t_chunk)
    cnc = _to_chunks(cn.astype(jnp.float32), t_chunk)
    tc = _to_chunks(targets, t_chunk)
    wc = _to_chunks(mask.astype(jnp.float32), t_chunk)

    def body(acc, xs):
        x_o, x_n, c_o, c_n, tt, ww = xs
        lse_o, tgt_o = _head_chunk(x_o, w_o, b_o, tt, v)
        lse_n, tgt_n = _head_chunk(x_n, w_n, b_n, tt, v)
        p = c_o * jnp.exp(tgt_o - lse_o) + c_n * jnp.exp(tgt_n - lse_n)
        return acc + jnp.sum(ww * -jnp.log2(p + 1e-20)), None

    acc, _ = jax.lax.scan(body, jnp.asarray(0.0, jnp.float32),
                          (xo, xn, coc, cnc, tc, wc))
    return acc


# --------------------------------------------------------------------------
# two-head probability-mixture CE (the SentiCap switched loss,
# ``senticap/mrnn/mrnn_switched.py:860-884,1006-1057``): the materialized
# form mixes two (B, T, V) softmaxes per token before taking the target
# probability.  Only the per-token TARGET probability of each head is needed
# for the value, so the chunked form keeps just the two (B, T) logsumexp
# residual planes; the backward recomputes each chunk's softmaxes.
# --------------------------------------------------------------------------

_PROB_FLOOR = 1e-37  # mrnn.py:563


def _head_chunk(x, w, b, tt, v):
    """One head on one chunk -> (lse (B,tc), tgt_logit (B,tc))."""
    logits = (x @ w + b).astype(jnp.float32)                 # (B, tc, V)
    m = jnp.max(logits, axis=-1)
    lse = m + jnp.log(jnp.sum(jnp.exp(logits - m[..., None]), axis=-1))
    tgt = jnp.sum(logits * jax.nn.one_hot(tt, v, dtype=logits.dtype),
                  axis=-1)
    return lse, tgt


@functools.partial(jax.custom_vjp, nondiff_argnums=(10,))
def _mixture_ce(hh_o, hh_n, co, cn, w_o, b_o, w_n, b_n, targets, weights,
                t_chunk):
    """``sum(weights * -log(max(co*p_o + cn*p_n, 1e-37)))`` where
    ``p_* = softmax(hh_* @ w_* + b_*)[target]`` — the (B, T, V)
    distributions never materialize.  ``co``/``cn`` are per-token mixture
    coefficients (B, T); their cotangents are ``-w/p_mix * p_{o,n}`` so the
    caller's coefficient construction (e.g. ``1-att``/``att``) chains
    through XLA.  Floored positions get zero gradient, exactly like the
    materialized ``max``."""
    loss, _, _ = _mixture_forward(hh_o, hh_n, co, cn, w_o, b_o, w_n, b_n,
                                  targets, weights, t_chunk)
    return loss


def _mixture_forward(hh_o, hh_n, co, cn, w_o, b_o, w_n, b_n, targets,
                     weights, t_chunk):
    v = w_o.shape[-1]
    xo = _to_chunks(hh_o, t_chunk)
    xn = _to_chunks(hh_n, t_chunk)
    coc = _to_chunks(co, t_chunk)
    cnc = _to_chunks(cn, t_chunk)
    tc_ = _to_chunks(targets, t_chunk)
    wc = _to_chunks(weights, t_chunk)

    def body(acc, xs):
        x_o, x_n, c_o, c_n, tt, ww = xs
        lse_o, tgt_o = _head_chunk(x_o, w_o, b_o, tt, v)
        lse_n, tgt_n = _head_chunk(x_n, w_n, b_n, tt, v)
        p_mix = (c_o * jnp.exp(tgt_o - lse_o)
                 + c_n * jnp.exp(tgt_n - lse_n))
        nll = -jnp.log(jnp.maximum(p_mix, _PROB_FLOOR))
        return acc + jnp.sum(ww * nll), (lse_o, lse_n)

    loss, (lses_o, lses_n) = jax.lax.scan(
        body, jnp.asarray(0.0, jnp.float32), (xo, xn, coc, cnc, tc_, wc))
    return loss, lses_o, lses_n


def _mixture_fwd(hh_o, hh_n, co, cn, w_o, b_o, w_n, b_n, targets, weights,
                 t_chunk):
    loss, lses_o, lses_n = _mixture_forward(
        hh_o, hh_n, co, cn, w_o, b_o, w_n, b_n, targets, weights, t_chunk)
    return loss, (hh_o, hh_n, co, cn, w_o, b_o, w_n, b_n, targets, weights,
                  lses_o, lses_n)


def _mixture_bwd(t_chunk, res, g):
    (hh_o, hh_n, co, cn, w_o, b_o, w_n, b_n, targets, weights,
     lses_o, lses_n) = res
    b, t = targets.shape
    v = w_o.shape[-1]
    xo = _to_chunks(hh_o, t_chunk)
    xn = _to_chunks(hh_n, t_chunk)
    coc = _to_chunks(co, t_chunk)
    cnc = _to_chunks(cn, t_chunk)
    tc_ = _to_chunks(targets, t_chunk)
    wc = _to_chunks(weights, t_chunk)
    wo32 = w_o.astype(jnp.float32)
    wn32 = w_n.astype(jnp.float32)

    def head_recompute(x, w, b_, tt, lse):
        """One head's chunk logits -> (softmax p (B,tc,V), onehot,
        target prob (B,tc)) — materialized ONCE per head per chunk (the
        (B,tc,V) matmul dominates the backward)."""
        logits = (x @ w + b_).astype(jnp.float32)
        p = jnp.exp(logits - lse[..., None])                 # (B, tc, V)
        onehot = jax.nn.one_hot(tt, v, dtype=jnp.float32)
        p_tgt = jnp.sum(p * onehot, axis=-1)
        return p, onehot, p_tgt

    def head_bwd(x, w32, p, onehot, fac):
        """``fac`` = dloss/dp_tgt * p_tgt (B, tc); returns dx, dW, db."""
        dl = fac[..., None] * (onehot - p)                   # (B, tc, V)
        dx = jnp.einsum("btv,hv->bth", dl, w32).astype(x.dtype)
        dw = jnp.einsum("bth,btv->hv", x.astype(jnp.float32), dl)
        db = jnp.sum(dl, axis=(0, 1))
        return dx, dw, db

    def body(carry, xs):
        dwo, dbo, dwn, dbn = carry
        x_o, x_n, c_o, c_n, tt, ww, lse_o, lse_n = xs
        pv_o, oh_o, p_o = head_recompute(x_o, w_o, b_o, tt, lse_o)
        pv_n, oh_n, p_n = head_recompute(x_n, w_n, b_n, tt, lse_n)
        p_mix = c_o * p_o + c_n * p_n
        live = (p_mix > _PROB_FLOOR).astype(jnp.float32)
        g_p = -(ww * g) * live / jnp.maximum(p_mix, _PROB_FLOOR)
        d_co = g_p * p_o
        d_cn = g_p * p_n
        dx_o, dw_o, db_o = head_bwd(x_o, wo32, pv_o, oh_o, g_p * c_o * p_o)
        dx_n, dw_n, db_n = head_bwd(x_n, wn32, pv_n, oh_n, g_p * c_n * p_n)
        return ((dwo + dw_o, dbo + db_o, dwn + dw_n, dbn + db_n),
                (dx_o, dx_n, d_co, d_cn))

    (dwo, dbo, dwn, dbn), (dxo, dxn, dco, dcn) = jax.lax.scan(
        body,
        (jnp.zeros(w_o.shape, jnp.float32), jnp.zeros(b_o.shape, jnp.float32),
         jnp.zeros(w_n.shape, jnp.float32), jnp.zeros(b_n.shape, jnp.float32)),
        (xo, xn, coc, cnc, tc_, wc, lses_o, lses_n))

    def unchunk(xc, like):
        x = jnp.moveaxis(xc, 0, 1)
        x = x.reshape((b, -1) + x.shape[3:])[:, :t]
        return x.astype(like.dtype)

    return (unchunk(dxo, hh_o), unchunk(dxn, hh_n),
            unchunk(dco, co), unchunk(dcn, cn),
            dwo.astype(w_o.dtype), dbo.astype(b_o.dtype),
            dwn.astype(w_n.dtype), dbn.astype(b_n.dtype), None, None)


_mixture_ce.defvjp(_mixture_fwd, _mixture_bwd)


def mixture_ce_from_hiddens(
    hh_o: jax.Array,         # (B, T, H) background head input (post-dropout)
    hh_n: jax.Array,         # (B, T, H) sentiment head input (post-dropout)
    co: jax.Array,           # (B, T) background mixture coefficient
    cn: jax.Array,           # (B, T) sentiment mixture coefficient
    w_o: jax.Array, b_o: jax.Array,
    w_n: jax.Array, b_n: jax.Array,
    targets: jax.Array,      # (B, T) int
    weights: jax.Array,      # (B, T) float — mask (x CE reweighting)
    t_chunk: Optional[int] = None,
) -> jax.Array:
    """Chunked ``sum(weights * -log(max(co*p_o + cn*p_n, 1e-37)))`` — the
    SentiCap switched mixture CE without materializing either (B, T, V)
    distribution."""
    b, t = targets.shape
    if t_chunk is None:
        t_chunk = auto_t_chunk(b, t)
    return _mixture_ce(hh_o, hh_n, co.astype(jnp.float32),
                       cn.astype(jnp.float32), w_o, b_o, w_n, b_n,
                       targets, weights.astype(jnp.float32), t_chunk)


def masked_sum_ce_from_hiddens(
    hiddens: jax.Array,      # (B, T, H)
    head_w: jax.Array,       # (H, V)
    head_b: jax.Array,       # (V,)
    targets: jax.Array,      # (B, T) int
    mask: jax.Array,         # (B, T) float/bool weights
    clamp: Optional[float] = None,
    t_chunk: Optional[int] = None,
) -> jax.Array:
    """Masked token-SUM CE (the SentiCap convention, ``mrnn.py:560-567``):
    ``sum(mask * -log(max(softmax(hh @ W + b)[y], exp(-clamp))))`` without
    materializing the probabilities."""
    b, t = targets.shape
    weights = mask.astype(jnp.float32)
    if t_chunk is None:
        t_chunk = auto_t_chunk(b, t)
    return _weighted_ce(hiddens, head_w, head_b, targets, weights, t_chunk,
                        clamp)
