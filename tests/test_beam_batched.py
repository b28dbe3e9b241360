"""beam_search_batched (native batch) must equal vmap(beam_search)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icee_tpu.core.config import DecoderConfig
from icee_tpu.decode.beam import beam_search, beam_search_batched
from icee_tpu.models import factored_lstm as fl

K = 5


def _model(seed, vocab=64):
    cfg = DecoderConfig(vocab_size=vocab, embed_size=16, hidden_size=32,
                        factored_size=32, max_seq_length=10)
    return cfg, fl.init_params(jax.random.PRNGKey(seed), cfg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_matches_vmap(rng, seed):
    cfg, dec = _model(seed)
    batch = 6
    feats = jnp.asarray(
        rng.standard_normal((batch, K, cfg.embed_size)).astype(np.float32))
    style = jnp.asarray(seed % 4)

    def one(feat):
        return beam_search(
            embed_fn=lambda t: fl.embed(dec, t),
            step_fn=lambda x, s: fl.decode_step(dec, x, s, style),
            init_model_state=fl.initial_state(K, cfg),
            start_token=1, end_token=2, k=K,
            max_seq_length=cfg.max_seq_length, vocab_size=cfg.vocab_size,
            first_input=feat)

    want = jax.vmap(one)(feats)

    got = beam_search_batched(
        embed_fn=lambda t: fl.embed(dec, t),
        step_fn=lambda x, s: fl.decode_step(dec, x, s, style),
        init_model_state=fl.initial_state(batch * K, cfg),
        start_token=1, end_token=2, k=K,
        max_seq_length=cfg.max_seq_length, vocab_size=cfg.vocab_size,
        batch=batch, first_input=feats)

    np.testing.assert_array_equal(np.asarray(got.length),
                                  np.asarray(want.length))
    for b in range(batch):
        L = int(want.length[b])
        np.testing.assert_array_equal(np.asarray(got.tokens[b, :L]),
                                      np.asarray(want.tokens[b, :L]))
    np.testing.assert_allclose(np.asarray(got.score), np.asarray(want.score),
                               rtol=1e-5, atol=1e-5)
