"""Shape-stable beam search under ``jit``.

The reference's beam (``stylenet/model.py:198-294``, ``model_att.py:307-426``,
``app/backend/model.py`` serving copies) shrinks the live beam dynamically:
each step takes the top-``n_alive`` expansions, moves any that emit ``<end>``
into a "completed" list, and re-slices every tensor to the surviving beams —
shapes change every step, which cannot compile.

This implementation is a *proved-equivalent* masked formulation (equivalence
is tested against a Python transcription of the reference algorithm in
``tests/test_beam.py``):

- ``k`` slots persist for the whole decode; dead slots contribute ``-inf``
  rows, so the flat top-``k`` over ``(k, V)`` returns the reference's
  candidates in descending-score order.  Candidate rank IS its sorted
  position, so "the reference's top-``n_alive``" is just ``rank < n_alive``
  — no compaction or sorting beyond the top-k itself,
- candidates that emit ``<end>`` fold into a running best-completed
  (score, sequence) pair instead of a buffer: the reference ultimately
  returns only the max-raw-score completion, ties resolved to the earliest
  entry (``model.py:291``), which strict-``>`` best-so-far tracking
  reproduces exactly,
- step 1 reproduces the reference's single-row special case (all slots
  identical, expand row 0 only: ``model.py:239-241``),
- termination and the no-completion fallback ``[<end>]`` (``model.py:
  288-289``) match the reference.

Serving-vs-research semantics: the stylenet research ``sample`` never feeds
the image feature into the LSTM (``model.py:224-227`` — a known bug), while
the serving copy feeds it as the step-1 input (``app/backend/model.py``).
Pass ``first_input`` for the serving semantics or ``None`` to reproduce the
research path; both are supported for checkpoint parity.

Batch over images with ``jax.vmap`` — the whole search is one jitted
``lax.while_loop``, so hundreds of images decode in parallel on one chip.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

NEG_INF = -1e30


class BeamResult(NamedTuple):
    """Best sequence (including ``<start>`` at position 0 and ``<end>`` when
    present), its length, and its raw cumulative log-probability."""

    tokens: jax.Array   # (max_len,) int32, padded with end_token
    length: jax.Array   # () int32 — number of valid tokens incl. specials
    score: jax.Array    # () float32


class _State(NamedTuple):
    step: jax.Array
    alive: jax.Array           # (k,) bool — slot holds a live beam
    scores: jax.Array          # (k,) f32 — -inf on dead slots
    seqs: jax.Array            # (k, L)
    seq_len: jax.Array         # () — tokens filled so far (same for all slots)
    prev_words: jax.Array      # (k,)
    model_state: object        # pytree with leading dim k per leaf
    best_score: jax.Array      # () f32 — best completed so far (NEG_INF none)
    best_seq: jax.Array        # (L,)
    best_len: jax.Array        # ()


def beam_search(
    embed_fn: Callable[[jax.Array], jax.Array],
    step_fn: Callable,
    init_model_state,
    start_token: int,
    end_token: int,
    k: int,
    max_seq_length: int,
    vocab_size: int,
    first_input: Optional[jax.Array] = None,
) -> BeamResult:
    """Run the reference beam search for ONE image (vmap for batches).

    ``step_fn(x, model_state) -> (logits (k, V), model_state)`` — the model
    step over ``k`` beam slots.  ``init_model_state`` leaves must have leading
    dim ``k``.  ``first_input``: optional (k, E) step-1 input (image feature,
    serving semantics).
    """
    max_len = max_seq_length + 2  # <start> + max_seq_length emissions + slack
    seqs0 = jnp.full((k, max_len), end_token, jnp.int32)
    seqs0 = seqs0.at[:, 0].set(start_token)
    rank = jnp.arange(k)

    state0 = _State(
        step=jnp.asarray(1, jnp.int32),
        alive=jnp.ones((k,), bool),
        scores=jnp.zeros((k,), jnp.float32),
        seqs=seqs0,
        seq_len=jnp.asarray(1, jnp.int32),
        prev_words=jnp.full((k,), start_token, jnp.int32),
        model_state=init_model_state,
        best_score=jnp.asarray(NEG_INF, jnp.float32),
        best_seq=jnp.full((max_len,), end_token, jnp.int32),
        best_len=jnp.asarray(0, jnp.int32),
    )

    def cond(s: _State):
        # reference: loop while beams remain, with the step check AFTER the
        # body ("if step > max_seq_length: break" post-work), i.e. the body
        # runs for step values 1..max_seq_length+1.
        return jnp.any(s.alive) & (s.step <= max_seq_length + 1)

    def body(s: _State) -> _State:
        is_first = s.step == 1
        x_emb = embed_fn(s.prev_words)
        if first_input is not None:
            x = jnp.where(is_first, first_input.astype(x_emb.dtype), x_emb)
        else:
            x = x_emb
        # dead rows never compete; at step 1 only row 0 competes (model.py:239)
        row_ok = jnp.where(is_first, rank == 0, s.alive)
        logits, model_state = step_fn(x, s.model_state)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        total = s.scores[:, None] + logp  # (k, V)
        total = jnp.where(row_ok[:, None], total, NEG_INF)
        top_scores, top_idx = jax.lax.top_k(total.reshape(-1), k)
        prev_idx = top_idx // vocab_size
        words = top_idx % vocab_size

        # the reference materializes only the top-n_alive candidates
        # (top-k at step 1); rank == sorted position
        n_take = jnp.where(is_first, k, jnp.sum(s.alive))
        valid = rank < n_take

        # extend sequences: candidate i inherits slot prev_idx[i]'s history
        new_seqs = s.seqs[prev_idx].at[:, s.seq_len].set(words)
        new_model_state = jax.tree_util.tree_map(
            lambda leaf: leaf[prev_idx], model_state
        )

        completed = valid & (words == end_token)
        still = valid & (words != end_token)

        # best-completed update: argmax over this step's completions, in
        # candidate-rank order (matches the reference's list-order tiebreak)
        comp_scores = jnp.where(completed, top_scores, NEG_INF)
        i_best = jnp.argmax(comp_scores)
        step_best = comp_scores[i_best]
        improves = step_best > s.best_score
        best_score = jnp.where(improves, step_best, s.best_score)
        best_seq = jnp.where(improves, new_seqs[i_best], s.best_seq)
        best_len = jnp.where(improves, s.seq_len + 1, s.best_len)

        return _State(
            step=s.step + 1,
            alive=still,
            scores=jnp.where(still, top_scores, NEG_INF),
            seqs=new_seqs,
            seq_len=s.seq_len + 1,
            prev_words=words,
            model_state=new_model_state,
            best_score=best_score,
            best_seq=best_seq,
            best_len=best_len,
        )

    final = jax.lax.while_loop(cond, body, state0)

    has_any = final.best_score > NEG_INF / 2
    # fallback: bare [<end>] sequence (model.py:288-289)
    fallback = jnp.full((max_len,), end_token, jnp.int32)
    tokens = jnp.where(has_any, final.best_seq, fallback)
    length = jnp.where(has_any, final.best_len, 1)
    score = jnp.where(has_any, final.best_score,
                      jnp.asarray(NEG_INF, jnp.float32))
    return BeamResult(tokens=tokens, length=length, score=score)


def beam_search_batched(
    embed_fn: Callable[[jax.Array], jax.Array],
    step_fn: Callable,
    init_model_state,
    start_token: int,
    end_token: int,
    k: int,
    max_seq_length: int,
    vocab_size: int,
    batch: int,
    first_input: Optional[jax.Array] = None,
) -> BeamResult:
    """Natively batched beam search over ``batch`` images at once.

    Semantically identical to ``vmap(beam_search)`` (tested), but the model
    step runs on one flat ``(batch*k, ...)`` row block: one large head
    matmul per step instead of per-image 5-row ones.

    ``init_model_state`` leaves are flat rows ``(batch*k, ...)``;
    ``first_input`` is ``(batch, k, E)``.  Returns BeamResult with a leading
    batch dim.
    """
    max_len = max_seq_length + 2
    rows = batch * k
    width = vocab_size

    seqs0 = jnp.full((batch, k, max_len), end_token, jnp.int32)
    seqs0 = seqs0.at[:, :, 0].set(start_token)
    rank = jnp.arange(k)[None, :]  # (1, k)

    state0 = _State(
        step=jnp.asarray(1, jnp.int32),
        alive=jnp.ones((batch, k), bool),
        scores=jnp.zeros((batch, k), jnp.float32),
        seqs=seqs0,
        seq_len=jnp.asarray(1, jnp.int32),
        prev_words=jnp.full((batch, k), start_token, jnp.int32),
        model_state=init_model_state,
        best_score=jnp.full((batch,), NEG_INF, jnp.float32),
        best_seq=jnp.full((batch, max_len), end_token, jnp.int32),
        best_len=jnp.zeros((batch,), jnp.int32),
    )

    def cond(s: _State):
        return jnp.any(s.alive) & (s.step <= max_seq_length + 1)

    def body(s: _State) -> _State:
        is_first = s.step == 1
        x_emb = embed_fn(s.prev_words.reshape(rows))
        if first_input is not None:
            x = jnp.where(is_first,
                          first_input.reshape(rows, -1).astype(x_emb.dtype),
                          x_emb)
        else:
            x = x_emb

        row_ok = jnp.where(is_first, rank == 0, s.alive)  # (batch, k)
        logits, model_state = step_fn(x, s.model_state)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        total = s.scores.reshape(rows, 1) + logp
        total = total.reshape(batch, k, width)
        total = jnp.where(row_ok[:, :, None], total, NEG_INF)

        top_scores, idx = jax.lax.top_k(total.reshape(batch, k * width), k)
        prev_idx = idx // width                              # (batch, k)
        words = idx % width

        n_take = jnp.where(is_first, k, jnp.sum(s.alive, axis=1, keepdims=True))
        valid = rank < n_take                                # (batch, k)

        new_seqs = jnp.take_along_axis(s.seqs, prev_idx[:, :, None], axis=1)
        new_seqs = new_seqs.at[:, :, s.seq_len].set(words)
        flat_gather = (jnp.arange(batch)[:, None] * k + prev_idx).reshape(rows)
        new_model_state = jax.tree_util.tree_map(
            lambda leaf: leaf[flat_gather], model_state)

        completed = valid & (words == end_token)
        still = valid & (words != end_token)

        comp_scores = jnp.where(completed, top_scores, NEG_INF)
        i_best = jnp.argmax(comp_scores, axis=1)
        step_best = jnp.take_along_axis(comp_scores, i_best[:, None],
                                        axis=1)[:, 0]
        improves = step_best > s.best_score
        best_score = jnp.where(improves, step_best, s.best_score)
        best_row = jnp.take_along_axis(new_seqs, i_best[:, None, None],
                                       axis=1)[:, 0]
        best_seq = jnp.where(improves[:, None], best_row, s.best_seq)
        best_len = jnp.where(improves, s.seq_len + 1, s.best_len)

        return _State(
            step=s.step + 1,
            alive=still,
            scores=jnp.where(still, top_scores, NEG_INF),
            seqs=new_seqs,
            seq_len=s.seq_len + 1,
            prev_words=words,
            model_state=new_model_state,
            best_score=best_score,
            best_seq=best_seq,
            best_len=best_len,
        )

    final = jax.lax.while_loop(cond, body, state0)

    has_any = final.best_score > NEG_INF / 2
    fallback = jnp.full((batch, max_len), end_token, jnp.int32)
    tokens = jnp.where(has_any[:, None], final.best_seq, fallback)
    length = jnp.where(has_any, final.best_len, 1)
    score = jnp.where(has_any, final.best_score, NEG_INF)
    return BeamResult(tokens=tokens, length=length, score=score)
