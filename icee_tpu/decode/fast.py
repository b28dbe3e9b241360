"""Batched beam decode for the four caption families, on one device or many.

One place builds the jitted ``(feats, style) -> BeamResult`` function that
``serve/batching.py``, ``cli/evaluate.py``, ``cli/caption_batch.py`` and the
benchmark use.  Every step is plain XLA: each family's own ``decode_step``
(recurrence + vocabulary head), then ``log_softmax`` and ``top_k`` inside
``beam_search_batched``.  A fused head + top-k kernel lost its end-to-end
A/B on the H100 and was removed (docs/KERNELS.md).

Feature layout: the global families (``stylenet``, ``nic``) take pooled
encoder features ``(batch, E)`` fed at step 1 (serving semantics; the
research semantics of ``feed_feature=False`` ignore them), the attention
families take spatial features ``(batch, P, FS)``.
"""

from __future__ import annotations

from typing import Callable

FAMILIES = ("stylenet", "nic", "stylenet_att", "nic_att")


def beam_fn(
    family: str,
    dec_params: dict,
    batch: int,
    k: int,
    max_seq_length: int,
    vocab_size: int,
    start_token: int,
    end_token: int,
    feed_feature: bool = True,
    jit: bool = True,
) -> Callable:
    """Jitted ``(feats, style) -> BeamResult`` (leading batch dim) for
    ``family``.  ``style`` is a traced style id (ignored by the NIC
    families), so one compiled program serves every mode.  ``jit=False``
    returns the traceable function (for ``shard_map``).
    """
    import jax
    import jax.numpy as jnp

    from icee_tpu.decode.beam import beam_search_batched
    from icee_tpu.models import attention as att_mod
    from icee_tpu.models import factored_lstm as fl
    from icee_tpu.models import lstm as nic

    if family not in FAMILIES:
        raise ValueError(f"unknown decoder family {family!r}; "
                         f"want one of {FAMILIES}")
    factored = family.startswith("stylenet")
    hidden = (dec_params["C_w"] if factored else dec_params["linear_w"])

    def embed(t):
        return (fl.embed(dec_params, t) if factored
                else jnp.take(dec_params["embed"], t, axis=0))

    def run(feats, style):
        style = jnp.asarray(style)
        rows = batch * k
        first = None
        if family.endswith("_att"):
            att = (att_mod._select_attention(dec_params["attention"], style)
                   if factored else dec_params["attention"])
            # the encoder projection is h-independent: once per image, not
            # once per beam row and step
            att1_k = jnp.repeat(feats @ att["enc_w"] + att["enc_b"], k,
                                axis=0)
            feats_k = jnp.repeat(feats, k, axis=0)
            init = att_mod.init_hidden_state(dec_params, feats_k)
            if factored:
                def step(x, s):
                    logits, _, s2 = att_mod.factored_att_decode_step(
                        dec_params, x, feats_k, s, style, att1=att1_k)
                    return logits, s2
            else:
                def step(x, s):
                    logits, _, s2 = att_mod.rnn_att_decode_step(
                        dec_params, x, feats_k, s, att1=att1_k)
                    return logits, s2
        else:
            zeros = jnp.zeros((rows, hidden.shape[0]), hidden.dtype)
            init = (zeros, zeros)
            if factored:
                def step(x, s):
                    return fl.decode_step(dec_params, x, s, style)
            else:
                def step(x, s):
                    return nic.decode_step(dec_params, x, s)
            if feed_feature:
                first = jnp.repeat(feats[:, None, :], k, axis=1)

        return beam_search_batched(
            embed_fn=embed, step_fn=step, init_model_state=init,
            start_token=start_token, end_token=end_token, k=k,
            max_seq_length=max_seq_length, vocab_size=vocab_size,
            batch=batch, first_input=first)

    return jax.jit(run) if jit else run


def sharded_beam_fn(family: str, dec_params: dict, mesh, batch: int,
                    **kw) -> Callable:
    """Data-parallel :func:`beam_fn` over ``mesh``'s data axis.

    Beam decode is independent per image, so each device decodes its shard
    of the batch with replicated parameters and no collectives; tokens are
    identical to the one-device decode.  ``kw`` as for :func:`beam_fn`.
    """
    import jax
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from icee_tpu.decode.beam import BeamResult
    from icee_tpu.parallel.mesh import DATA_AXIS

    n_data = mesh.shape[DATA_AXIS]
    if batch % n_data:
        raise ValueError(f"batch {batch} does not split over {n_data} "
                         "data shards")
    local = beam_fn(family, dec_params, batch // n_data, jit=False, **kw)
    spec = P(DATA_AXIS)
    fn = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec, P()),
        out_specs=BeamResult(tokens=spec, length=spec, score=spec),
        check_vma=False))

    def run(feats, style):
        return fn(jax.device_put(feats, NamedSharding(mesh, spec)), style)

    return run
