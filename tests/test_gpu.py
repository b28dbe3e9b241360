"""Card-only tests: they need an NVIDIA GPU and skip elsewhere (the ``gpu``
fixture decides when the test runs).  ``python chip_smoke.py`` runs them in
its kernel phase; by hand: ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/test_gpu.py``."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import SERVE_GAIN_BIAS  # noqa: E402

pytestmark = pytest.mark.gpu


def test_backend_policy_on_the_card(gpu):
    from icee_tpu.core import backend

    assert backend.require_gpu()[0].platform == "gpu"
    assert "platform=gpu" in backend.device_line()
    assert backend.resolve_chunked_ce(None) == backend.CHUNKED_CE_DEFAULT[
        "gpu"]


@pytest.mark.parametrize("family", ["stylenet", "nic", "stylenet_att",
                                    "nic_att"])
def test_batched_beam_matches_per_image_on_the_card(gpu, family):
    """The batched XLA beam at flagship widths equals the same beam run per
    image (vmapped) on the card at "highest" precision."""
    import jax
    import jax.numpy as jnp

    from icee_tpu.core.config import AttentionDecoderConfig, DecoderConfig
    from icee_tpu.decode.fast import beam_fn
    from icee_tpu.models import attention as att_mod
    from icee_tpu.models import factored_lstm as fl
    from icee_tpu.models import lstm as nic_mod

    att = family.endswith("_att")
    cfg = (AttentionDecoderConfig(vocab_size=8192) if att
           else DecoderConfig(vocab_size=8192))
    init = {"stylenet": fl.init_params, "nic": nic_mod.init_params,
            "stylenet_att": att_mod.init_factored_att_params,
            "nic_att": att_mod.init_rnn_att_params}[family]
    # the served smoke decoders' gain and <end> bias, so that most beams end
    # before the step limit (chip_smoke.SERVE_GAIN_BIAS)
    gain, bias = SERVE_GAIN_BIAS[family]
    dec = jax.tree_util.tree_map(lambda a: a * gain,
                                 init(jax.random.PRNGKey(0), cfg))
    head_b = "C_b" if "C_b" in dec else "linear_b"
    dec[head_b] = dec[head_b].at[2].add(bias)
    batch, k = 8, 5
    shape = (batch, 196, 2048) if att else (batch, cfg.embed_size)
    # features of the scale the random backbone gives (order 0.05)
    feats = jnp.asarray(0.05 * np.random.default_rng(0).standard_normal(
        shape), jnp.float32)
    style = jnp.asarray(1)
    with jax.default_matmul_precision("highest"):
        got = beam_fn(family, dec, batch, k, cfg.max_seq_length, 8192, 1,
                      2)(feats, style)
        want = jax.vmap(lambda f: beam_fn(
            family, dec, 1, k, cfg.max_seq_length, 8192, 1, 2,
            jit=False)(f[None], style))(feats)
    np.testing.assert_array_equal(np.asarray(got.tokens),
                                  np.asarray(want.tokens)[:, 0])
