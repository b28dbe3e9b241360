"""The batched XLA beam (``decode/fast.py``) against the per-image oracle
(``decode/beam.py::beam_search``, vmapped) for all four decoder families,
over the beam widths, styles and feature semantics the serving and
evaluation paths use."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icee_tpu.core.config import AttentionDecoderConfig, DecoderConfig
from icee_tpu.decode.beam import beam_search
from icee_tpu.decode.fast import FAMILIES, beam_fn
from icee_tpu.models import attention as att_mod
from icee_tpu.models import factored_lstm as fl
from icee_tpu.models import lstm as nic_mod

V, STEPS, P, FS = 97, 7, 5, 12
COMMON = dict(vocab_size=V, embed_size=10, hidden_size=16, factored_size=16,
              feature_size=FS, max_seq_length=STEPS)


def _model(family, seed):
    att = family.endswith("_att")
    cfg = (AttentionDecoderConfig(attention_size=8, **COMMON) if att
           else DecoderConfig(**COMMON))
    init = {"stylenet": fl.init_params, "nic": nic_mod.init_params,
            "stylenet_att": att_mod.init_factored_att_params,
            "nic_att": att_mod.init_rnn_att_params}[family]
    return cfg, init(jax.random.PRNGKey(seed), cfg)


def _oracle(family, dec, feat, style, k, feed_feature):
    """beam_search for ONE image with the family's own decode step."""
    if family.endswith("_att"):
        feats_k = jnp.repeat(feat[None], k, axis=0)
        if family == "stylenet_att":
            def step(x, s):
                logits, _, s2 = att_mod.factored_att_decode_step(
                    dec, x, feats_k, s, style)
                return logits, s2
            embed = lambda t: fl.embed(dec, t)  # noqa: E731
        else:
            def step(x, s):
                logits, _, s2 = att_mod.rnn_att_decode_step(
                    dec, x, feats_k, s)
                return logits, s2
            embed = lambda t: jnp.take(dec["embed"], t, axis=0)  # noqa: E731
        init, first = att_mod.init_hidden_state(dec, feats_k), None
    else:
        if family == "stylenet":
            step = lambda x, s: fl.decode_step(dec, x, s, style)  # noqa: E731
            embed = lambda t: fl.embed(dec, t)  # noqa: E731
        else:
            step = lambda x, s: nic_mod.decode_step(dec, x, s)  # noqa: E731
            embed = lambda t: nic_mod.embed(dec, t)  # noqa: E731
        z = jnp.zeros((k, COMMON["hidden_size"]))
        init = (z, z)
        first = (jnp.tile(feat[None], (k, 1))
                 if feed_feature or family == "nic" else None)
    return beam_search(embed_fn=embed, step_fn=step, init_model_state=init,
                       start_token=1, end_token=2, k=k,
                       max_seq_length=STEPS, vocab_size=V, first_input=first)


def _check(family, k, style, feed_feature, seed, batch=3):
    cfg, dec = _model(family, seed)
    rng = np.random.default_rng(seed)
    shape = (batch, P, FS) if family.endswith("_att") else (batch, 10)
    feats = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    got = beam_fn(family, dec, batch, k, STEPS, V, 1, 2,
                  feed_feature=feed_feature)(feats, style)
    want = jax.vmap(lambda f: _oracle(family, dec, f, jnp.asarray(style), k,
                                      feed_feature))(feats)
    np.testing.assert_array_equal(np.asarray(got.length),
                                  np.asarray(want.length))
    np.testing.assert_array_equal(np.asarray(got.tokens),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(np.asarray(got.score), np.asarray(want.score),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("style", [0, 1, 3])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("family", FAMILIES)
def test_batched_beam_matches_per_image_oracle(family, k, style):
    _check(family, k, style, feed_feature=True, seed=k + style)


@pytest.mark.parametrize("style", [0, 2])
def test_research_semantics_ignore_the_feature(style):
    """``feed_feature=False`` (the research ``sample()``, feature never fed)
    matches the oracle and does not depend on the features at all."""
    _check("stylenet", 5, style, feed_feature=False, seed=11)
    _, dec = _model("stylenet", 11)
    fn = beam_fn("stylenet", dec, 2, 5, STEPS, V, 1, 2, feed_feature=False)
    a = fn(jnp.zeros((2, 10)), style)
    b = fn(jnp.ones((2, 10)), style)
    np.testing.assert_array_equal(np.asarray(a.tokens), np.asarray(b.tokens))


def test_unknown_family_is_refused():
    _, dec = _model("stylenet", 0)
    with pytest.raises(ValueError, match="unknown decoder family"):
        beam_fn("transformer", dec, 2, 5, STEPS, V, 1, 2)
