"""Gradient rule of the XLA training scans (the recurrences that replaced
the whole-scan kernels): ``jax.grad`` of each family's training forward
against central differences in float64, along a random direction in
parameter space.  Covers teacher forcing 1.0 (the all-teacher scan) and 0.8
(scheduled sampling with argmax feedback), at batch sizes that are not a
multiple of 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


from icee_tpu.core.config import AttentionDecoderConfig, DecoderConfig
from icee_tpu.models import attention as att_mod
from icee_tpu.models import factored_lstm as fl
from icee_tpu.models import lstm as nic_mod
from icee_tpu.senticap import model as sc_base
from icee_tpu.senticap import switched as sc_sw
from icee_tpu.senticap.config import senticap_conf

V, T, E, H, P, FS = 23, 5, 6, 8, 4, 7
FAMILIES = ("factored", "nic", "factored_att", "nic_att",
            "senticap_base", "senticap_switched")


def _setup(family, tf, batch, rng):
    """-> (params, fn(params) -> array of hidden states / outputs)."""
    caps = jnp.asarray(rng.integers(3, V, (batch, T)))  # int64 under x64
    key = jax.random.PRNGKey(3)
    if family.startswith("senticap"):
        conf = senticap_conf(emb_size=E, lstm_hidden_size=H, visual_size=FS,
                             MAX_SENTENCE_LEN=T - 1)
        v = jnp.asarray(rng.standard_normal((batch, FS)))
        x_drop = jnp.asarray(rng.integers(0, 2, (batch, T, E)) * 2.0)
        y_drop = jnp.asarray(rng.integers(0, 2, (batch, T, H)) * 2.0)
        if family == "senticap_base":
            params = sc_base.init_params(key, V, conf)
            if tf >= 1.0:
                return params, lambda p: sc_base.forward(
                    p, conf, caps, v, True, x_drop, y_drop,
                    return_hiddens=True)
            forced = jnp.asarray(rng.random((batch, T)) < tf, jnp.float32)
            return params, lambda p: sc_base.forward_semi_forced(
                p, conf, caps, v, forced, x_drop, y_drop,
                return_hiddens=True)
        params = sc_sw.init_params(key, V, conf)
        # tf < 1 here: the materialized mixture distributions instead of
        # the hidden states the chunked loss takes
        return params, lambda p: sc_sw.forward(
            p, conf, caps, v, jnp.asarray(1.0), x_drop, y_drop,
            return_hiddens=tf >= 1.0)[0]
    common = dict(vocab_size=V, embed_size=E, hidden_size=H, factored_size=H,
                  feature_size=FS, dropout=0.3)
    if family.endswith("_att"):
        cfg = AttentionDecoderConfig(attention_size=5, **common)
        feats = jnp.asarray(rng.standard_normal((batch, P, FS)))
        if family == "factored_att":
            params = att_mod.init_factored_att_params(key, cfg)
            return params, lambda p: att_mod.factored_att_forward_hiddens(
                p, cfg, caps, feats, 2, tf, jax.random.PRNGKey(7), True)
        params = att_mod.init_rnn_att_params(key, cfg)
        return params, lambda p: att_mod.rnn_att_forward_hiddens(
            p, cfg, caps, feats, tf, jax.random.PRNGKey(7), True)
    cfg = DecoderConfig(**common)
    feats = jnp.asarray(rng.standard_normal((batch, E)))
    if family == "factored":
        params = fl.init_params(key, cfg)
        return params, lambda p: fl.forward_hiddens(
            p, cfg, caps, feats, 1, tf, jax.random.PRNGKey(7), True)
    params = nic_mod.init_params(key, cfg)
    return params, lambda p: nic_mod.forward_hiddens(
        p, cfg, caps, feats, tf, jax.random.PRNGKey(7), True)


@pytest.mark.parametrize("batch", [3, 5])
@pytest.mark.parametrize("tf", [1.0, 0.8])
@pytest.mark.parametrize("family", FAMILIES)
def test_scan_gradient_matches_central_differences(family, tf, batch):
    rng = np.random.default_rng(hash((family, tf, batch)) % 2**31)
    with jax.enable_x64(True):
        params, fn = _setup(family, tf, batch, rng)
        params = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, params)
        probe = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.1),
            jax.tree_util.tree_leaves(fn(params)))

        def loss(p):
            outs = jax.tree_util.tree_leaves(fn(p))
            return sum(jnp.sum(o * w) for o, w in zip(outs, probe))

        direction = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape)), params)
        grad = jax.grad(loss)(params)
        analytic = sum(jnp.sum(g * d) for g, d in zip(
            jax.tree_util.tree_leaves(grad),
            jax.tree_util.tree_leaves(direction)))
        # the factored and SentiCap cells accumulate in float32
        # (preferred_element_type): a step of 1e-4 keeps float32 roundoff
        # near 1e-3 of the derivative while crossing few relu / argmax
        # kinks; the all-float64 NIC cells take 1e-6
        f32_cells = not family.startswith("nic")
        eps = 1e-4 if f32_cells else 1e-6
        shift = lambda s: jax.tree_util.tree_map(  # noqa: E731
            lambda x, d: x + s * eps * d, params, direction)
        numeric = (loss(shift(1.0)) - loss(shift(-1.0))) / (2 * eps)
        # float32 roundoff in the loss is relative to the size of its
        # terms, not of their (possibly cancelling) sum
        scale = sum(float(jnp.sum(jnp.abs(o * w))) for o, w in zip(
            jax.tree_util.tree_leaves(fn(params)), probe))
        assert float(loss(params)) != 0.0
        np.testing.assert_allclose(
            float(analytic), float(numeric),
            rtol=2e-3 if f32_cells else 1e-5,
            atol=(1e-7 / eps) * scale if f32_cells else 1e-9)
