"""SentiCap training drivers (reference ``train_mscoco.py`` /
``train_joint.py``, SURVEY C10) in JAX.

The reference compiles a Theano ``train(indx)`` whose minibatch gather
happens on device from shared arrays (``mrnn.py:570-677``); here the split
is device-resident (``io.device_dataset``) and one jitted step gathers rows
by an index vector, computes the forward/loss/cost, and applies the
reference RMSProp pipeline — the whole epoch runs as N device calls with no
host transfer but the index vectors.

``train_base``   = COCO base-model regime (``train_mscoco.py:1-59``).
``train_switched`` = the switch ("gap filler") regime: load a base model,
seed both paths, optimize ONLY the switch set with the LAMBDA_N/LAMBDA_GAM
loss (``train_joint.py:322-451``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from icee_tpu.senticap import io as sio
from icee_tpu.senticap import model as base_model
from icee_tpu.senticap import switched as sw_model
from icee_tpu.senticap.config import senticap_conf
from icee_tpu.senticap.solver import make_solver


def _epoch_indices(n: int, batch: int, rng: np.random.Generator):
    idx = rng.permutation(n)
    n_batches = n // batch
    return idx[: n_batches * batch].reshape(n_batches, batch)


def _epoch_indices_by_sentiment(senti: np.ndarray, batch: int,
                                rng: np.random.Generator):
    """Sentiment-homogeneous minibatches in random order.

    The switched model's recurrence branches on the BATCH-level sentiment
    ``senti[0]`` (``mrnn_switched.py:860-884``), which is only meaningful
    when a batch is sentiment-pure; the reference achieves this implicitly
    by slicing contiguous dataset blocks.  A global shuffle would mix +1/-1
    records and mislabel part of every batch, so shuffle WITHIN each
    sentiment group and interleave the groups' batches randomly."""
    batches = []
    for value in np.unique(senti):
        group = np.flatnonzero(senti == value)
        rng.shuffle(group)
        n_batches = len(group) // batch
        for b in range(n_batches):
            batches.append(group[b * batch:(b + 1) * batch])
    order = rng.permutation(len(batches))
    return [batches[i] for i in order]


def _shard_batch(arrs, mesh):
    """Constrain gathered minibatch tensors to the mesh's data axis so the
    forward/backward runs data-parallel (params replicated, gradient
    all-reduce between devices — SURVEY §2.5 applied to the
    device-resident senticap regime)."""
    if mesh is None:
        return arrs
    from jax.sharding import NamedSharding, PartitionSpec as P

    from icee_tpu.parallel.mesh import DATA_AXIS

    s = NamedSharding(mesh, P(DATA_AXIS))
    return tuple(jax.lax.with_sharding_constraint(a, s) for a in arrs)


def make_base_step(conf: dict, solver, mesh=None):
    """Jitted base-model step over device-resident data; ``mesh`` shards
    the gathered minibatch over the data axis (DP).

    ``conf["CHUNKED_CE"]`` (default None = the backend's choice,
    ``core/backend.py``) computes the loss from hidden states in time chunks
    so the (B, T, V) distributions never materialize (``ops/chunked_loss.py``); only applies
    to ``SOFTMAX_OUT`` models."""
    return jax.jit(_base_step_impl(conf, solver, mesh))


def _base_step_impl(conf: dict, solver, mesh=None):
    """Unjitted base-model step body — shared verbatim by the per-batch
    jitted step (:func:`make_base_step`) and the whole-epoch scan
    (:func:`make_base_epoch`), so the two paths cannot diverge."""
    use_chunked = (base_model.chunked_ce_requested(conf)
                   and conf.get("SOFTMAX_OUT", True))

    def step(params, opt_state, data, idx, key):
        x = data["X"][idx]
        y = data["Y"][idx]
        mask = data["Xlen"][idx]
        v = data["V"][idx]
        x, y, mask, v = _shard_batch((x, y, mask, v), mesh)
        kx, ky, k_forced = jax.random.split(key, 3)
        b, t = x.shape
        x_drop = jax.random.bernoulli(
            kx, 1.0 - conf["DROP_INPUT_FRACTION"],
            (b, t, conf["emb_size"])).astype(jnp.float32) / (
                1.0 - conf["DROP_INPUT_FRACTION"])
        y_drop = jax.random.bernoulli(
            ky, 1.0 - conf["DROP_OUTPUT_FRACTION"],
            (b, t, conf["lstm_hidden_size"])).astype(jnp.float32) / (
                1.0 - conf["DROP_OUTPUT_FRACTION"])

        semi = float(conf.get("SEMI_FORCED", 1.0))
        if semi < 1.0:
            # reference regime: per-(sample, step) Bernoulli(SEMI_FORCED)
            # forced matrix feeding the semi-forced scan (mrnn.py:496-503);
            # NOTE: drawn from its own key — re-splitting the consumed key
            # would alias k_forced with ky and couple the forced matrix to
            # the output-dropout mask
            forced = jax.random.bernoulli(k_forced, semi, x.shape).astype(
                jnp.float32)
        else:
            forced = jnp.ones_like(x, jnp.float32)

        def grads_of(p, x, y, mask, v, x_drop, y_drop, forced):
            def cost_fn(p):
                if semi < 1.0:
                    out = base_model.forward_semi_forced(
                        p, conf, x, v, forced, x_drop, y_drop,
                        return_hiddens=use_chunked)
                else:
                    out = base_model.forward(p, conf, x, v, True, x_drop,
                                             y_drop,
                                             return_hiddens=use_chunked)
                if use_chunked:
                    loss = base_model.loss_fn_from_hiddens(p, out, y, mask)
                else:
                    loss = base_model.loss_fn(out, y, mask)
                l2 = sum(jnp.sum(q ** 2)
                         for q in jax.tree_util.tree_leaves(p))
                return loss + conf["L2_REG_CONST"] * l2, loss

            (_, loss), grads = jax.value_and_grad(
                cost_fn, has_aux=True)(p)
            return grads, loss

        grads, loss = grads_of(params, x, y, mask, v, x_drop, y_drop, forced)
        updates, opt_state = solver.update(grads, opt_state, params)
        import optax

        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_switched_step(conf: dict, solver, mesh=None):
    """Jitted switched-model step; ``conf["CHUNKED_CE"]`` (default None =
    the backend's choice) computes the mixture CE from the two
    heads' hidden states in time chunks so neither (B, T, V) distribution
    materializes (``ops/chunked_loss.mixture_ce_from_hiddens``)."""
    return jax.jit(_switched_step_impl(conf, solver, mesh))


def _switched_step_impl(conf: dict, solver, mesh=None):
    """Unjitted switched-model step body (see :func:`_base_step_impl`)."""
    use_chunked = base_model.chunked_ce_requested(conf)

    def step(params, opt_state, data, idx, key):
        x = data["X"][idx]
        y = data["Y"][idx]
        mask = data["Xlen"][idx]
        v = data["V"][idx]
        sw = data["SW"][idx]
        x, y, mask, v, sw = _shard_batch((x, y, mask, v, sw), mesh)
        senti0 = data["senti"][idx][0]
        kx, ky = jax.random.split(key)
        b, t = x.shape
        x_drop = jax.random.bernoulli(
            kx, 1.0 - conf["DROP_INPUT_FRACTION"],
            (b, t, conf["emb_size"])).astype(jnp.float32) / (
                1.0 - conf["DROP_INPUT_FRACTION"])
        y_drop = jax.random.bernoulli(
            ky, 1.0 - conf["DROP_OUTPUT_FRACTION"],
            (b, t, conf["lstm_hidden_size"])).astype(jnp.float32) / (
                1.0 - conf["DROP_OUTPUT_FRACTION"])
        tmask = sw_model.switch_param_mask(params)

        def grads_of(p, x, y, mask, v, sw, x_drop, y_drop):
            def cost_fn(p):
                if use_chunked:
                    (hh_o, hh_n, att), la, l1a = sw_model.forward(
                        p, conf, x, v, senti0, x_drop, y_drop,
                        return_hiddens=True)
                    loss = sw_model.loss_fn_from_hiddens(
                        p, conf, hh_o, hh_n, att, senti0, y, mask, sw,
                        la, l1a)
                else:
                    s, la, l1a = sw_model.forward(p, conf, x, v, senti0,
                                                  x_drop, y_drop)
                    loss = sw_model.loss_fn(conf, s, y, mask, sw, la, l1a)
                reg = sw_model.cost_fn(p, conf, jnp.asarray(0.0), tmask)
                return loss + reg, loss

            (_, loss), grads = jax.value_and_grad(
                cost_fn, has_aux=True)(p)
            return grads, loss

        grads, loss = grads_of(params, x, y, mask, v, sw, x_drop, y_drop)
        updates, opt_state = solver.update(grads, opt_state, params)
        import optax

        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def _make_epoch(step_impl):
    """Whole-epoch device-resident program: ONE jitted ``lax.scan`` over the
    epoch's (n_batches, batch) index rows, each iteration running the same
    step body as the per-batch path and splitting the carried key exactly
    like the host loop (``key, k = split(key)`` per batch) — parameters,
    optimizer state, and the key stream bit-match the per-batch dispatches.

    The reference's whole epoch is N compiled ``train(indx)`` calls
    (``mrnn.py:727-770``); here the epoch is a single dispatch (the host
    ships only the int32 index matrix)."""

    @jax.jit
    def epoch(params, opt_state, data, idx_rows, key):
        def body(carry, bidx):
            params, opt_state, key = carry
            key, k = jax.random.split(key)
            params, opt_state, loss = step_impl(params, opt_state, data,
                                                bidx, k)
            return (params, opt_state, key), loss

        (params, opt_state, key), losses = jax.lax.scan(
            body, (params, opt_state, key), idx_rows)
        return params, opt_state, key, losses

    return epoch


def make_base_epoch(conf: dict, solver, mesh=None):
    """One-dispatch whole-epoch base-model training (see :func:`_make_epoch`)."""
    return _make_epoch(_base_step_impl(conf, solver, mesh))


def make_switched_epoch(conf: dict, solver, mesh=None):
    """One-dispatch whole-epoch switch training; each index row must be
    sentiment-pure (:func:`_epoch_indices_by_sentiment`) because the step
    reads the batch-level ``senti[idx][0]``."""
    return _make_epoch(_switched_step_impl(conf, solver, mesh))


def train_base(
    dataset: sio.SentiDataset,
    vocab_size: int,
    conf: Optional[dict] = None,
    num_epochs: int = 10,
    unigram: Optional[np.ndarray] = None,
    callbacks: Optional[list] = None,
    seed: int = 0,
    mesh=None,
    device_epoch: bool = False,
):
    """Base-model training loop (``train_complete``, ``mrnn.py:727-770``);
    pass a ``("data","model")`` mesh to run minibatches data-parallel;
    ``device_epoch`` runs each epoch as ONE jitted scan (bit-matching the
    per-batch path)."""
    conf = conf or senticap_conf()
    params = base_model.init_params(jax.random.PRNGKey(seed), vocab_size,
                                    conf, unigram)
    solver = make_solver(conf)
    if mesh is not None:
        from icee_tpu.parallel.train import place_replicated

        params = place_replicated(params, mesh)
    opt_state = solver.init(params)
    step = (make_base_epoch if device_epoch
            else make_base_step)(conf, solver, mesh)
    data = sio.device_dataset(dataset)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    batch = min(conf["batch_size_val"], dataset.X.shape[0])
    for epoch in range(num_epochs):
        t0 = time.time()
        idx_rows = _epoch_indices(dataset.X.shape[0], batch, rng)
        if device_epoch:
            params, opt_state, key, losses = step(
                params, opt_state, data, jnp.asarray(idx_rows), key)
            losses = list(np.asarray(losses, np.float64))
        else:
            losses = []
            for idx in idx_rows:
                key, k = jax.random.split(key)
                params, opt_state, loss = step(params, opt_state, data,
                                               jnp.asarray(idx), k)
                losses.append(float(loss))
        print(f"[senticap base] epoch {epoch}: loss "
              f"{np.mean(losses):.3f} ({time.time() - t0:.1f}s)")
        for cb in callbacks or []:
            cb(epoch, params)
    return params, opt_state


def train_switched(
    dataset: sio.SentiDataset,
    base_params: dict,
    vocab_size: int,
    conf: Optional[dict] = None,
    num_epochs: int = 10,
    callbacks: Optional[list] = None,
    seed: int = 0,
    init_params_override: Optional[dict] = None,
    mesh=None,
    device_epoch: bool = False,
):
    """Switch training (``run_train_gap_filler``, ``train_joint.py:322-451``):
    seed both paths from the base model, train only the switch set.

    ``init_params_override``: a pre-built switched parameter set (e.g. after
    vocab surgery) used instead of re-initializing from ``base_params``.
    ``mesh``: run minibatches data-parallel over the mesh's data axis.
    ``device_epoch``: each epoch as ONE jitted scan over the
    sentiment-pure index rows (bit-matching the per-batch path)."""
    conf = conf or senticap_conf()
    if init_params_override is not None:
        params = init_params_override
    else:
        params = sw_model.init_params(jax.random.PRNGKey(seed), vocab_size,
                                      conf, base=base_params)
    solver = make_solver(conf, sw_model.switch_param_mask(params))
    if mesh is not None:
        from icee_tpu.parallel.train import place_replicated

        params = place_replicated(params, mesh)
    opt_state = solver.init(params)
    step = (make_switched_epoch if device_epoch
            else make_switched_step)(conf, solver, mesh)
    data = sio.device_dataset(dataset)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    batch = min(conf["batch_size_val"], dataset.X.shape[0])
    for epoch in range(num_epochs):
        t0 = time.time()
        batches = _epoch_indices_by_sentiment(dataset.senti, batch, rng)
        if device_epoch and batches:
            params, opt_state, key, losses = step(
                params, opt_state, data,
                jnp.asarray(np.stack(batches)), key)
            losses = list(np.asarray(losses, np.float64))
        else:
            losses = []
            for idx in batches:
                key, k = jax.random.split(key)
                params, opt_state, loss = step(params, opt_state, data,
                                               jnp.asarray(idx), k)
                losses.append(float(loss))
        print(f"[senticap switch] epoch {epoch}: loss "
              f"{np.mean(losses):.3f} ({time.time() - t0:.1f}s)")
        for cb in callbacks or []:
            cb(epoch, params)
    return params, opt_state


def validation_perplexity(params, conf, dataset: sio.SentiDataset,
                          switched: bool = False, base_only: bool = False
                          ) -> float:
    """Masked corpus perplexity (``get_val_perplexity``; ``base_only``
    evaluates the background model inside a switched param set,
    ``mrnn_switched.py:1301``).  With ``conf["CHUNKED_CE"]``
    the (B, T, V) distributions never materialize — the whole val split
    evaluates in one pass through the chunked neglog2 reductions."""
    use_chunked = (base_model.chunked_ce_requested(conf)
                   and conf.get("SOFTMAX_OUT", True))
    data = sio.device_dataset(dataset)
    y, mask = data["Y"], data["Xlen"]
    if switched and not base_only:
        if use_chunked:
            from icee_tpu.ops.chunked_loss import (
                mixture_neglog2_sum_from_hiddens)

            (hh_o, hh_n, att), _, _ = sw_model.forward(
                params, conf, data["X"], data["V"], data["senti"][0],
                return_hiddens=True)
            co, cn = sw_model.mixture_coefficients(conf, att,
                                                   data["senti"][0])
            hsum = mixture_neglog2_sum_from_hiddens(
                hh_o, hh_n, co, cn, params["w"], params["b"],
                params["w_sw"], params["b_sw"], y, mask)
            return float(2.0 ** (hsum / jnp.sum(mask)))
        s, _, _ = sw_model.forward(params, conf, data["X"], data["V"],
                                   data["senti"][0])
    else:
        p = {k: params[k] for k in ("wemb", "w_lstm", "w", "b", "wvm", "bmv")}
        if use_chunked:
            from icee_tpu.ops.chunked_loss import (
                masked_neglog2_sum_from_hiddens)

            hh = base_model.forward(p, conf, data["X"], data["V"],
                                    return_hiddens=True)
            hsum = masked_neglog2_sum_from_hiddens(
                hh, p["w"], p["b"], y, mask)
            return float(2.0 ** (hsum / jnp.sum(mask)))
        s = base_model.forward(p, conf, data["X"], data["V"])
    return float(base_model.perplexity(s, y, mask))


def make_beam_step(params, conf, switched: bool):
    """``(senti_val) -> step_fn`` for :func:`make_device_beam`'s contract
    (``step_fn(words, use_v, h, c, v_row)``); jit-traceable."""

    def make(senti_val):
        def one(words, use_v, h, c, v_row):
            b = words.shape[0]
            vv = jnp.broadcast_to(v_row[None, :], (b, v_row.shape[0]))
            if switched:
                return sw_model.one_step(
                    params, conf, words, use_v, h, c, vv,
                    jnp.asarray(senti_val))
            s, h2, c2 = base_model.one_step(
                params, conf, words, jnp.broadcast_to(use_v, (b,)),
                h, c, vv)
            return s, h2, c2

        return one

    return make


def decode_split(params, conf, dataset: sio.SentiDataset, i2w: Dict[int, str],
                 switched: bool = True, beam_size: int = 20,
                 device: bool = True):
    """Test path (``run_load_gap_filler``, ``train_joint.py:91-320``): per
    image decode the styled (senti=+1) and descriptive (senti=-1) sentence
    with attention traces.

    ``device=True`` runs the WHOLE split's searches as vmapped jitted
    device programs (:func:`icee_tpu.senticap.beam.make_device_beam`'s raw
    runner over the feature batch — one dispatch per sentiment instead of
    one per caption); ``device=False`` keeps the host-driven oracle loop
    (the reference's per-token compiled-function protocol)."""
    import jax

    from icee_tpu.senticap.beam import beam_decode, make_device_beam

    out = []
    hs = conf["lstm_hidden_size"]
    width = 2 * hs if switched else hs
    max_len = conf["MAX_SENTENCE_LEN"]
    make = make_beam_step(params, conf, switched)

    if device:
        v_all = jnp.asarray(dataset.V)
        dec_des = make_device_beam(make(-1.0), width, beam_size, max_len)
        d_sc, d_seq, d_len, _ = jax.jit(jax.vmap(dec_des.run))(v_all)
        d_seq, d_len = np.asarray(d_seq), np.asarray(d_len)
        if switched:
            dec_att = make_device_beam(make(1.0), width, beam_size,
                                       max_len, with_attention=True)
            _, p_seq, p_len, p_att = jax.jit(jax.vmap(dec_att.run))(v_all)
            p_seq, p_len, p_att = (np.asarray(p_seq), np.asarray(p_len),
                                   np.asarray(p_att))

    for i in range(dataset.V.shape[0]):
        v_row = jnp.asarray(dataset.V[i])

        def host_step(senti_val):
            step = make(senti_val)

            def one(words, use_v, h, c):
                b = len(words)
                h_in = jnp.zeros((b, width)) if h is None else jnp.asarray(h)
                c_in = jnp.zeros((b, width)) if c is None else jnp.asarray(c)
                return step(jnp.asarray(words), jnp.asarray(use_v),
                            h_in, c_in, v_row)

            return one

        if switched:
            if device:
                n = int(p_len[i])
                pos_ids = [int(w) for w in p_seq[i, :n]]
                att = [float(a) for a in p_att[i, :n]]
                des_ids = [int(w) for w in d_seq[i, :int(d_len[i])]]
            else:
                _, pos_ids, att = beam_decode(host_step(1.0), dataset.V[i],
                                              beam_size, max_len,
                                              with_attention=True)
                _, des_ids = beam_decode(host_step(-1.0), dataset.V[i],
                                         beam_size, max_len)
            out.append({
                "image": dataset.ids[i],
                "positive": [i2w[w] for w in pos_ids[:-1]],
                "descriptive": [i2w[w] for w in des_ids[:-1]],
                "attention": att,
            })
        else:
            if device:
                ids = [int(w) for w in d_seq[i, :int(d_len[i])]]
            else:
                _, ids = beam_decode(host_step(-1.0), dataset.V[i],
                                     beam_size, max_len)
            out.append({"image": dataset.ids[i],
                        "caption": [i2w[w] for w in ids[:-1]]})
    return out
