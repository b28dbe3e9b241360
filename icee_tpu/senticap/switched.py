"""SentiCap switched two-LSTM model in JAX.

Parity target: ``mrnn_switched.py`` (SURVEY.md C3) — the actual SentiCap
method: a frozen-ish background caption LSTM plus a sentiment LSTM with a
duplicated weight set, mixed per step by a learned switch gate.

Per step (``mrnn_switched.py:780-890``):

- background path runs the ORIGINAL weights with no dropout,
- sentiment path runs the ``*_sw`` duplicate weights with dropout,
- switch gate ``att = sigmoid([hh_orig ; hh_new] @ att_w + att_b)``,
- output mixing by DOMAIN_ADAPT mode; ``DA_SUM``:
  ``s = s_orig`` when the batch sentiment is descriptive (senti <= -0.5),
  else ``(1-att) * s_orig + att * s_new``,
- the scan also emits ``log(att)`` / ``log(1-att)`` traces for the
  switch-supervision loss and test-time highlighting.

Loss (``:1006-1057``, DA_SUM):
``sum(CE*m) + LAMBDA_N * sum(CE*m*(1-sw))
 + sum((1+LAMBDA_N) * LAMBDA_GAM * (sw*(-log att) + (1-sw)*(-log(1-att))) * m)``
with ``sw`` the per-token ANP switch indicator; cost adds
``L2_REG_CONST * sum(p^2)`` over trainable params (``:1098-1111``), and the
``DA_SIMILAR_PARAM*`` modes add the orig-vs-sw similarity regularizer.

Switch training optimizes ONLY the duplicate+gate set
(``train_joint.py:355-359`` = ``config.SWITCH_PARAMS``).

Vocab surgery (``:480-518``): new sentiment words take the embedding/output
rows of their closest existing word; the reference measures closeness with
spacy word vectors (unavailable offline) — :func:`grow_vocab` accepts any
``closest_fn(word) -> existing_index``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from icee_tpu.senticap.config import (
    DA_FIXED_ALPHA,
    DA_SIMILAR_PARAM,
    DA_SIMILAR_PARAM_2,
    DA_SIMILAR_PARAM_3,
    DA_SUM,
    SWITCH_PARAMS,
    senticap_conf,
)
from icee_tpu.senticap.model import (
    cell,
    init_params as init_base_params,
    output_probs,
    visual_embedding,
)


def init_params(key: jax.Array, vocab_size: int, conf=None,
                base: Optional[dict] = None, dtype=jnp.float32) -> dict:
    """Full parameter set: originals + ``*_sw`` duplicates + gate.

    ``base``: a trained base-model pytree whose values seed BOTH paths
    (``mrnn_switched.py:523-548`` copies the pretrained set into the
    duplicates)."""
    conf = conf or senticap_conf()
    k1, k2, k3 = jax.random.split(key, 3)
    orig = base if base is not None else init_base_params(k1, vocab_size, conf,
                                                          dtype=dtype)
    dup = {f"{name}_sw": jnp.array(val) for name, val in orig.items()}
    h = conf["lstm_hidden_size"]
    a = np.sqrt(6.0 / (2 * h + 1))
    params = dict(orig)
    params.update(dup)
    params["att_w"] = jax.random.uniform(k3, (2 * h, 1), dtype, -a, a)
    params["att_b"] = jnp.zeros((1,), dtype)
    # dead sentiment-projection params, created (and listed trainable) for
    # parity with the reference (``mrnn_switched.py:574-580``); their only
    # use is commented out there (``:699-700``)
    a1 = np.sqrt(6.0 / (h + 1))
    kw1, kw2 = jax.random.split(k2)
    params["wsenti"] = jax.random.uniform(kw1, (h, 1), dtype, -a1, a1)
    params["wsenti2"] = jax.random.uniform(kw2, (h, 1), dtype, -a1, a1)
    return params


def switch_param_mask(params: dict) -> dict:
    """Trainable = the switch set only (``train_joint.py:355-359``)."""
    return {k: (k in SWITCH_PARAMS) for k in params}


def _base_view(params: dict, sw: bool) -> dict:
    names = ("wemb", "w_lstm", "w", "b", "wvm", "bmv")
    suffix = "_sw" if sw else ""
    return {n: params[f"{n}{suffix}"] for n in names}


def step(
    params: dict,
    conf: dict,
    word: jax.Array,        # (B,) int32
    use_v: jax.Array,       # () or (B,) bool
    h: jax.Array,           # (B, 2H) — [orig ; new] halves
    c: jax.Array,           # (B, 2H)
    v: jax.Array,           # (B, visual)
    senti0: jax.Array,      # () f32 — batch sentiment (<= -0.5 descriptive)
    x_drop: Optional[jax.Array] = None,
    y_drop: Optional[jax.Array] = None,
    return_hiddens: bool = False,
):
    """One switched recurrence -> (s_t, h, c, log_att, log_1m_att); with
    ``return_hiddens`` the two softmaxes are skipped and the first element
    is ``(head_in_o, head_in_n, att[:, 0])`` — the post-dropout head inputs
    plus the switch gate, enough for the chunked mixture loss
    (:func:`icee_tpu.ops.chunked_loss.mixture_ce_from_hiddens`)."""
    hs = conf["lstm_hidden_size"]
    gclip = conf["GRAD_CLIP_SIZE"]
    h_orig, h_new = h[:, :hs], h[:, hs:]
    c_orig, c_new = c[:, :hs], c[:, hs:]

    def run(base, h_i, c_i, xd, yd):
        emb = jnp.take(base["wemb"], word, axis=0)
        vis = v @ base["wvm"] + base["bmv"]
        x_t = jnp.where(use_v, vis, emb)  # scalar step flag broadcasts
        if conf["DROP_INPUT"] and xd is not None:
            x_t = x_t * xd
        h2, c2 = cell(base, x_t, h_i, c_i, gclip)
        hh = h2 * yd if (conf["DROP_OUTPUT"] and yd is not None) else h2
        if return_hiddens:
            return h2, c2, hh
        s = jax.nn.softmax(hh @ base["w"] + base["b"], axis=-1)
        return h2, c2, s

    # background path: no dropout (mrnn_switched.py:792-801)
    hh_o, cc_o, s_o = run(_base_view(params, False), h_orig, c_orig,
                          None, None)
    hh_n, cc_n, s_n = run(_base_view(params, True), h_new, c_new,
                          x_drop, y_drop)

    att = jax.nn.sigmoid(
        jnp.concatenate([hh_o, hh_n], axis=1) @ params["att_w"]
        + params["att_b"])                                  # (B, 1)

    if return_hiddens:
        h_out = jnp.concatenate([hh_o, hh_n], axis=1)
        c_out = jnp.concatenate([cc_o, cc_n], axis=1)
        # s_o/s_n here are the POST-dropout head inputs (see ``run``)
        return ((s_o, s_n, att[:, 0]), h_out, c_out,
                jnp.log(att), jnp.log(1.0 - att))

    descriptive = senti0 <= -0.5
    mode = conf["DOMAIN_ADAPT"]
    if mode == DA_SUM or mode == DA_SIMILAR_PARAM_3:
        mixed = (1.0 - att) * s_o + att * s_n
    elif mode == DA_FIXED_ALPHA:
        mixed = (1.0 - conf["FIXED_ALPHA"]) * s_o + conf["FIXED_ALPHA"] * s_n
    elif mode in (DA_SIMILAR_PARAM, DA_SIMILAR_PARAM_2):
        mixed = s_n
    else:
        raise ValueError(f"unknown DOMAIN_ADAPT {mode}")
    s_t = jnp.where(descriptive, s_o, mixed)

    h_out = jnp.concatenate([hh_o, hh_n], axis=1)
    c_out = jnp.concatenate([cc_o, cc_n], axis=1)
    return s_t, h_out, c_out, jnp.log(att), jnp.log(1.0 - att)


def forward(
    params: dict,
    conf: dict,
    words: jax.Array,       # (B, T)
    v: jax.Array,           # (B, visual)
    senti0: jax.Array,      # () batch sentiment
    x_drop: Optional[jax.Array] = None,
    y_drop: Optional[jax.Array] = None,
    use_visual: bool = True,
    return_hiddens: bool = False,
):
    """Teacher-forced scan -> (s (B,T,V), log_att (B,T), log_1m_att (B,T));
    with ``return_hiddens`` the first element is instead
    ``(hh_o (B,T,H), hh_n (B,T,H), att (B,T))`` — the post-dropout head
    inputs and switch gates for the chunked mixture loss (the (B, T, V)
    distributions never materialize)."""
    b, t = words.shape
    hs = conf["lstm_hidden_size"]
    if x_drop is None:
        x_drop = jnp.ones((b, t, conf["emb_size"]))
    if y_drop is None:
        y_drop = jnp.ones((b, t, hs))
    use_v = jnp.arange(t) == 0 if use_visual else jnp.zeros((t,), bool)

    def body(carry, xs):
        h, c = carry
        w_t, xd, yd, uv = xs
        s_t, h, c, la, l1a = step(params, conf, w_t, uv, h, c, v, senti0,
                                  xd, yd, return_hiddens=return_hiddens)
        return (h, c), (s_t, la[:, 0], l1a[:, 0])

    h0 = jnp.zeros((b, 2 * hs))
    c0 = jnp.zeros((b, 2 * hs))
    (_, _), (s, la, l1a) = jax.lax.scan(
        body, (h0, c0),
        (jnp.swapaxes(words, 0, 1), jnp.swapaxes(x_drop, 0, 1),
         jnp.swapaxes(y_drop, 0, 1), use_v))
    la = jnp.swapaxes(la, 0, 1)
    l1a = jnp.swapaxes(l1a, 0, 1)
    if return_hiddens:
        hh_o, hh_n, att = s
        return ((jnp.swapaxes(hh_o, 0, 1), jnp.swapaxes(hh_n, 0, 1),
                 jnp.swapaxes(att, 0, 1)), la, l1a)
    return jnp.swapaxes(s, 0, 1), la, l1a


def loss_fn(
    conf: dict,
    s: jax.Array,           # (B, T, V) probabilities
    y: jax.Array,           # (B, T) targets
    mask: jax.Array,        # (B, T)
    sw: jax.Array,          # (B, T) ANP switch indicator
    log_att: jax.Array,     # (B, T)
    log_1m_att: jax.Array,  # (B, T)
) -> jax.Array:
    """Switched loss (``mrnn_switched.py:1006-1057``)."""
    p = jnp.take_along_axis(s, y[..., None], axis=-1)[..., 0]
    ce = -jnp.log(jnp.maximum(p, 1e-37)) * mask
    base = jnp.sum(ce)
    mode = conf["DOMAIN_ADAPT"]
    if mode in (DA_FIXED_ALPHA, DA_SIMILAR_PARAM):
        return base
    neg = conf["LAMBDA_N"] * jnp.sum(ce * (1.0 - sw))
    if mode == DA_SIMILAR_PARAM_2:
        return base + neg
    gate = jnp.sum(
        (1.0 + conf["LAMBDA_N"]) * conf["LAMBDA_GAM"]
        * (sw * (-log_att) + (1.0 - sw) * (-log_1m_att)) * mask)
    return base + neg + gate


def mixture_coefficients(conf: dict, att: jax.Array, senti0: jax.Array
                         ) -> Tuple[jax.Array, jax.Array]:
    """Per-token mixture coefficients (co, cn) such that the switched
    output's target probability is ``co * p_orig + cn * p_new`` — the
    :func:`step` mixing rules (``mrnn_switched.py:860-884``) expressed in
    coefficient form for the chunked losses."""
    mode = conf["DOMAIN_ADAPT"]
    descriptive = senti0 <= -0.5
    if mode in (DA_SUM, DA_SIMILAR_PARAM_3):
        co_m, cn_m = 1.0 - att, att
    elif mode == DA_FIXED_ALPHA:
        alpha = jnp.full_like(att, conf["FIXED_ALPHA"])
        co_m, cn_m = 1.0 - alpha, alpha
    elif mode in (DA_SIMILAR_PARAM, DA_SIMILAR_PARAM_2):
        co_m, cn_m = jnp.zeros_like(att), jnp.ones_like(att)
    else:
        raise ValueError(f"unknown DOMAIN_ADAPT {mode}")
    co = jnp.where(descriptive, 1.0, co_m)
    cn = jnp.where(descriptive, 0.0, cn_m)
    return co, cn


def loss_fn_from_hiddens(
    params: dict,
    conf: dict,
    hh_o: jax.Array,        # (B, T, H) background head input (post-dropout)
    hh_n: jax.Array,        # (B, T, H) sentiment head input (post-dropout)
    att: jax.Array,         # (B, T) switch gate
    senti0: jax.Array,      # () batch sentiment
    y: jax.Array,           # (B, T) targets
    mask: jax.Array,        # (B, T)
    sw: jax.Array,          # (B, T) ANP switch indicator
    log_att: jax.Array,     # (B, T)
    log_1m_att: jax.Array,  # (B, T)
) -> jax.Array:
    """Same loss as :func:`loss_fn` computed from the hidden states — the
    two (B, T, V) distributions never materialize
    (``icee_tpu.ops.chunked_loss.mixture_ce_from_hiddens``).  The
    ``base + LAMBDA_N * (1-sw)`` CE pair folds into one weighted chunked
    pass; the V-free gate term is unchanged."""
    from icee_tpu.ops.chunked_loss import mixture_ce_from_hiddens

    mode = conf["DOMAIN_ADAPT"]
    co, cn = mixture_coefficients(conf, att, senti0)

    m = mask.astype(jnp.float32)
    if mode in (DA_FIXED_ALPHA, DA_SIMILAR_PARAM):
        weights = m                                  # base term only
    else:
        weights = m * (1.0 + conf["LAMBDA_N"] * (1.0 - sw))

    ce = mixture_ce_from_hiddens(
        hh_o, hh_n, co, cn, params["w"], params["b"],
        params["w_sw"], params["b_sw"], y, weights)
    if mode in (DA_FIXED_ALPHA, DA_SIMILAR_PARAM, DA_SIMILAR_PARAM_2):
        return ce
    gate = jnp.sum(
        (1.0 + conf["LAMBDA_N"]) * conf["LAMBDA_GAM"]
        * (sw * (-log_att) + (1.0 - sw) * (-log_1m_att)) * m)
    return ce + gate


def cost_fn(params: dict, conf: dict, loss: jax.Array,
            trainable_mask: Optional[dict] = None) -> jax.Array:
    """loss + L2 over trainable params (+ similarity reg for DA_SIMILAR_*)
    (``mrnn_switched.py:1098-1111``)."""
    mask = trainable_mask or {k: True for k in params}
    l2 = sum(jnp.sum(p ** 2) for k, p in params.items() if mask.get(k))
    cost = loss + conf["L2_REG_CONST"] * l2
    if conf["DOMAIN_ADAPT"] in (DA_SIMILAR_PARAM, DA_SIMILAR_PARAM_2,
                                DA_SIMILAR_PARAM_3):
        sim = (jnp.sum((params["w"] - params["w_sw"]) ** 2)
               + jnp.sum((params["b"] - params["b_sw"]) ** 2)
               + jnp.sum((params["w_lstm"] - params["w_lstm_sw"]) ** 2)
               + jnp.sum((params["wvm_sw"] - params["wvm"]) ** 2)
               + jnp.sum((params["bmv_sw"] - params["bmv"]) ** 2))
        cost = cost + conf["SIMILAR_PARAM_REG"] * sim
    return cost


def one_step(params: dict, conf: dict, word: jax.Array, use_v: jax.Array,
             h: jax.Array, c: jax.Array, v: jax.Array, senti0: jax.Array):
    """Inference step for beam search -> (s_t, h, c, att)."""
    s_t, h, c, la, _ = step(params, conf, word, use_v, h, c, v, senti0)
    return s_t, h, c, jnp.exp(la)


def make_embedding_closest_fn(
    base_wemb,
    base_w2i: Dict[str, int],
    token_lists,                      # iterable of token lists (the new
                                      # sentiment corpus the words come from)
    window: int = 4,
    exclude: Tuple[str, ...] = ("#START#", "#STOP#"),
) -> Callable[[str], int]:
    """Data-free realization of the reference's ``ClosestWordFinder``
    (``mrnn_switched.py:31-73``): map a new sentiment word to its closest
    EXISTING base-vocab word.

    The reference measures closeness with spacy word vectors — external
    data this environment cannot fetch.  The offline equivalent uses the
    model's OWN trained embedding space: a new word's distributional vector
    is the mean of the base ``wemb`` rows of its in-vocab context words
    (within ``window`` tokens across the sentiment corpus), and the closest
    word is the cosine-nearest base ``wemb`` row.  Same intent (semantic
    neighbour, e.g. "gloomy" -> "sad" when they share contexts), same
    interface, no external vectors.

    In-vocab words short-circuit to their own index
    (``get_closest_word``'s first branch, ``mrnn_switched.py:47-49``).
    Words with no usable context fall back to the most frequent in-corpus
    base word (still per-corpus, never a constant).
    """
    wemb = np.asarray(base_wemb, np.float64)
    n_base = wemb.shape[0]
    norms = np.linalg.norm(wemb, axis=1) + 1e-12
    unit = wemb / norms[:, None]
    excluded_ids = {base_w2i[w] for w in exclude if w in base_w2i}

    # context accumulation over the corpus (host-side, one pass)
    ctx_sum: Dict[str, np.ndarray] = {}
    ctx_cnt: Dict[str, int] = {}
    base_freq: Dict[int, int] = {}
    toks_cached = [list(toks) for toks in token_lists]
    for toks in toks_cached:
        ids = [base_w2i.get(t, -1) for t in toks]
        for j, t in enumerate(toks):
            if ids[j] >= 0:
                base_freq[ids[j]] = base_freq.get(ids[j], 0) + 1
                continue
            lo, hi = max(0, j - window), min(len(toks), j + window + 1)
            for k2 in range(lo, hi):
                if k2 == j or ids[k2] < 0 or ids[k2] in excluded_ids:
                    continue
                if t not in ctx_sum:
                    ctx_sum[t] = np.zeros(wemb.shape[1])
                    ctx_cnt[t] = 0
                ctx_sum[t] += wemb[ids[k2]]
                ctx_cnt[t] += 1
    freq_fallback = max(
        (i for i in base_freq if i not in excluded_ids),
        key=lambda i: (base_freq[i], -i), default=min(1, n_base - 1))

    def closest(word: str) -> int:
        if word in base_w2i:
            return base_w2i[word]
        if word not in ctx_sum or ctx_cnt[word] == 0:
            return freq_fallback
        q = ctx_sum[word] / ctx_cnt[word]
        qn = np.linalg.norm(q)
        if qn < 1e-12:
            return freq_fallback
        sims = unit @ (q / qn)
        for i in excluded_ids:
            sims[i] = -np.inf
        return int(np.argmax(sims))

    return closest


def grow_vocab(
    params: dict,
    added_words,                      # [(word, new_index), ...]
    closest_fn: Callable[[str], int],
) -> dict:
    """Vocab surgery (``mrnn_switched.py:480-518``): extend ``wemb`` rows /
    ``w`` columns / ``b`` entries (both paths) by copying the closest
    existing word's parameters."""
    out = dict(params)
    max_idx = max(i for _, i in added_words)
    for suffix in ("", "_sw"):
        wemb = np.asarray(out[f"wemb{suffix}"])
        w = np.asarray(out[f"w{suffix}"])
        b = np.asarray(out[f"b{suffix}"])
        n_new = max_idx - wemb.shape[0] + 1
        if n_new > 0:
            wemb = np.vstack([wemb, np.zeros((n_new, wemb.shape[1]),
                                             wemb.dtype)])
            w = np.hstack([w, np.zeros((w.shape[0], n_new), w.dtype)])
            b = np.concatenate([b, np.zeros((n_new,), b.dtype)])
        for word, i in added_words:
            ci = closest_fn(word)
            wemb[i, :] = wemb[ci, :]
            w[:, i] = w[:, ci]
            b[i] = b[ci]
        out[f"wemb{suffix}"] = jnp.asarray(wemb)
        out[f"w{suffix}"] = jnp.asarray(w)
        out[f"b{suffix}"] = jnp.asarray(b)
    return out
