"""SentiCap beam search: length-normalized log2 beams.

Parity target: ``decoder_beamsearch`` / ``decoder_beamsearch_with_attention``
(``mrnn_algorithms.py:113-209``):

- scores are ``-log2 p`` accumulated per word; the live beam is pruned by
  length-normalized score ``lp / c`` each step,
- a sequence completes on token 0 (STOP) or at length 20; completed results
  carry the final length-normalized score; the best (lowest) wins,
- the switched variant also records the per-step switch gate values for
  test-time highlighting (``train_joint.py``'s HTML output).

Two implementations, token-equivalent (tested):

- :func:`beam_decode` — host loop around the jitted ``one_step`` (the
  reference's compiled-function protocol, ``mrnn_algorithms.py:159-209``;
  kept as the oracle),
- :func:`make_device_beam` — the WHOLE search as one jitted ``lax.scan``
  program (shape-stable masked beams, results tracked in-carry).  One
  dispatch per decode instead of ~21, and the returned runner is
  ``jax.vmap``-able over images for batched test-set decoding.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def beam_decode(
    one_step_fn,
    v: np.ndarray,
    beam_size: int = 20,
    max_len: int = 20,
    stop_token: int = 0,
    with_attention: bool = False,
):
    """-> (best_norm_log2prob, token_list, [attention_trace]).

    ``one_step_fn(words (B,), use_v (), h, c) -> (s_t (B, V), h, c[, att])``
    with state leaves batched over live beams; first call is made with the
    visual flag set and a dummy word.
    """
    import jax.numpy as jnp

    # step 0: visual input
    out = one_step_fn(np.zeros((1,), np.int32), True, None, None)
    s_t, h, c = out[0], out[1], out[2]
    att0 = out[3] if with_attention else None

    # beam entries: (norm_lp, lp, count, words, row, att_trace)
    beams = [(0.0, 0.0, 0, [], 0, [])]
    state_h, state_c = np.asarray(h), np.asarray(c)
    probs = np.asarray(s_t)
    results: List[Tuple[float, int, List[int], List[float]]] = []

    for _ in range(max_len + 1):
        candidates = []
        for norm_lp, lp, cnt, words, row, att_tr in beams:
            all_lp = -np.log2(probs[row] + 1e-37)
            best_idx = np.argsort(all_lp)[:beam_size]
            att_here = (float(np.asarray(att0)[row, 0])
                        if with_attention and att0 is not None else None)
            for i in best_idx:
                new_lp = lp + float(all_lp[i])
                new_words = words + [int(i)]
                new_att = att_tr + ([att_here] if att_here is not None else [])
                if i == stop_token or cnt == max_len:
                    results.append((new_lp / (cnt + 1), cnt + 1, new_words,
                                    new_att))
                else:
                    candidates.append((new_lp / (cnt + 1), new_lp, cnt + 1,
                                       new_words, row, new_att))
        candidates.sort(key=lambda x: x[0])
        candidates = candidates[:beam_size]
        if not candidates:
            break
        # advance all surviving beams in one batched device step
        rows = np.asarray([c_[4] for c_ in candidates])
        words_in = np.asarray([c_[3][-1] for c_ in candidates], np.int32)
        h_in = state_h[rows]
        c_in = state_c[rows]
        out = one_step_fn(words_in, False, h_in, c_in)
        probs = np.asarray(out[0])
        state_h, state_c = np.asarray(out[1]), np.asarray(out[2])
        att0 = out[3] if with_attention else None
        beams = [(c_[0], c_[1], c_[2], c_[3], j, c_[5])
                 for j, c_ in enumerate(candidates)]

    results.sort(key=lambda x: x[0])
    best = results[0]
    if with_attention:
        return best[0], best[2], best[3]
    return best[0], best[2]


def make_device_beam(
    step_fn,
    state_width: int,
    beam_size: int = 20,
    max_len: int = 20,
    stop_token: int = 0,
    with_attention: bool = False,
):
    """Whole-search device beam: returns ``decode(v)`` mirroring
    :func:`beam_decode`'s result tuple.

    ``step_fn(words (B,), use_v () bool, h (B, S), c (B, S), v (visual,))
    -> (s_t (B, V), h, c[, att (B, 1)])`` must be jit-traceable.  The
    compiled program is reused across images (``v`` is an argument, not a
    closure constant), and ``run_jit`` can be ``jax.vmap``-ed over a feature
    batch for single-dispatch test-set decoding.

    Semantics match the host loop exactly: per live beam the ``beam_size``
    lowest -log2(p+1e-37) tokens become candidates; completed candidates
    (stop token, or length cap) update the running best by length-normalized
    score with first-come tie-break; survivors are the ``beam_size`` lowest
    accumulated-score candidates (``mrnn_algorithms.py:114-209``).
    """
    import jax
    import jax.numpy as jnp

    B, L = beam_size, max_len + 1
    INF = jnp.float32(np.inf)

    def run(v):
        out = step_fn(jnp.zeros((B,), jnp.int32), jnp.asarray(True),
                      jnp.zeros((B, state_width)),
                      jnp.zeros((B, state_width)), v)
        probs, h, c = out[0], out[1], out[2]
        att = out[3][:, 0] if with_attention else jnp.zeros((B,))

        lp0 = jnp.full((B,), INF).at[0].set(0.0)  # only beam 0 live at t=0
        seqs0 = jnp.full((B, L), stop_token, jnp.int32)
        att_tr0 = jnp.zeros((B, L))
        best0 = (INF, jnp.full((L,), stop_token, jnp.int32),
                 jnp.asarray(1, jnp.int32), jnp.zeros((L,)))

        def body(carry, t):
            probs, h, c, lp, seqs, att_tr, att_v, best = carry
            b_sc, b_seq, b_len, b_att = best
            nll = -jnp.log2(probs + 1e-37)
            neg_nll, tok = jax.lax.top_k(-nll, B)       # (B, K=B)
            cand_lp = lp[:, None] - neg_nll              # lp + nll
            is_stop = (tok == stop_token) | (t == max_len)
            norm = cand_lp / (t + 1.0).astype(jnp.float32)

            # completed candidates -> running best (first-min = insertion
            # order: beam row major, then per-row rank — the host's stable
            # sort order)
            res = jnp.where(is_stop, norm, INF).reshape(-1)
            ci = jnp.argmin(res)
            row, rk = ci // B, ci % B
            cand_seq = seqs[row].at[t].set(tok[row, rk])
            cand_att = att_tr[row].at[t].set(att_v[row])
            improves = res[ci] < b_sc
            best = (jnp.where(improves, res[ci], b_sc),
                    jnp.where(improves, cand_seq, b_seq),
                    jnp.where(improves, t + 1, b_len),
                    jnp.where(improves, cand_att, b_att))

            # surviving candidates: beam_size lowest accumulated scores
            live = jnp.where(is_stop, INF, cand_lp).reshape(-1)
            neg_sel, sel = jax.lax.top_k(-live, B)       # ties: lowest index
            new_lp = -neg_sel
            parent = sel // B
            words = tok.reshape(-1)[sel]
            new_h, new_c = h[parent], c[parent]
            new_seqs = seqs[parent].at[:, t].set(words)
            new_att_tr = att_tr[parent].at[:, t].set(att_v[parent])

            out = step_fn(words, jnp.asarray(False), new_h, new_c, v)
            probs2, h2, c2 = out[0], out[1], out[2]
            att2 = out[3][:, 0] if with_attention else jnp.zeros((B,))
            return (probs2, h2, c2, new_lp, new_seqs, new_att_tr, att2,
                    best), ()

        carry = (probs, h, c, lp0, seqs0, att_tr0, att, best0)
        (carry, _) = jax.lax.scan(body, carry,
                                  jnp.arange(L, dtype=jnp.int32))
        b_sc, b_seq, b_len, b_att = carry[-1]
        return b_sc, b_seq, b_len, b_att

    run_jit = jax.jit(run)

    def decode(v):
        b_sc, b_seq, b_len, b_att = run_jit(jnp.asarray(v))
        n = int(b_len)
        words = [int(w) for w in np.asarray(b_seq)[:n]]
        if with_attention:
            return float(b_sc), words, [float(a)
                                        for a in np.asarray(b_att)[:n]]
        return float(b_sc), words

    decode.run = run          # raw jittable fn (vmap over a feature batch)
    return decode
