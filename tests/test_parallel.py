"""Multi-device sharding on the virtual 8-device CPU mesh: the full factored
train step runs data+tensor parallel and matches the single-device result."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icee_tpu.core.config import DecoderConfig, EncoderConfig, TrainConfig
from icee_tpu.data.pipeline import make_batch
from icee_tpu.models import encoder as enc_mod
from icee_tpu.models import factored_lstm as fl
from icee_tpu.parallel import mesh as pmesh
from icee_tpu.parallel import train as ptrain
from icee_tpu.train import optim
from icee_tpu.train.steps import make_caption_steps

V, E, H, F, FEAT = 64, 16, 32, 32, 24
CFG = DecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                    factored_size=F, dropout=0.0)
TCFG = TrainConfig(teacher_forcing_ratio=1.0)
ECFG = EncoderConfig(embed_size=E, feature_size=FEAT)


def _batch(rng, b=8, t=10):
    caps = [[1] + list(rng.integers(4, V, t - 2)) + [2] for _ in range(b)]
    batch = make_batch(caps, max_len=t, batch_size=b)
    pooled = rng.standard_normal((b, FEAT)).astype(np.float32)
    return batch, pooled


def test_eight_virtual_devices_present():
    assert jax.device_count() == 8


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_sharded_train_step_matches_single_device(shape, rng):
    mesh = pmesh.make_mesh(shape)
    dec = fl.init_params(jax.random.PRNGKey(0), CFG)
    head = enc_mod.init_head_params(jax.random.PRNGKey(1), ECFG)
    tx = optim.make_adam(1e-2, TCFG)
    lang = optim.make_adam(1e-2, TCFG)
    fac, _, _ = make_caption_steps(CFG, TCFG, tx, lang, True)
    batch, pooled = _batch(rng)
    key = jax.random.PRNGKey(7)

    # single-device reference
    opt_state = tx.init((dec, head))
    dec1, head1, _, loss1 = fac(
        dec, head, opt_state, jnp.asarray(pooled),
        jnp.asarray(batch.captions), jnp.asarray(batch.lengths),
        jnp.asarray(batch.sample_mask), key)

    # sharded run: same step function, placed inputs
    dec_s = ptrain.place_decoder(dec, mesh)
    head_s = ptrain.place_replicated(head, mesh)
    opt_state_s = tx.init((dec_s, head_s))
    pooled_s, caps_s, lens_s, mask_s = ptrain.place_batch(
        mesh, jnp.asarray(pooled), jnp.asarray(batch.captions),
        jnp.asarray(batch.lengths), jnp.asarray(batch.sample_mask))
    dec2, head2, _, loss2 = fac(dec_s, head_s, opt_state_s, pooled_s, caps_s,
                                lens_s, mask_s, key)

    # sharded reductions reorder float sums; tolerances cover psum noise
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(dec1["C_w"]), np.asarray(dec2["C_w"]),
                               rtol=1e-3, atol=1e-4)

    if shape[1] > 1:
        # the vocab head really is sharded over the model axis
        sh = dec2["C_w"].sharding
        assert pmesh.MODEL_AXIS in str(sh.spec)


def test_vocab_sharding_specs():
    mesh = pmesh.make_mesh((4, 2))
    dec = fl.init_params(jax.random.PRNGKey(0), CFG)
    specs = pmesh.decoder_param_shardings(dec, mesh)
    assert "model" in str(specs["B"].spec)
    assert "model" in str(specs["C_w"].spec)
    assert str(specs["S_w"].spec) == "PartitionSpec()"


def test_beam_decode_under_data_parallel(rng):
    """Batched beam decode shards over images (pure DP serving path)."""
    from icee_tpu.decode.beam import beam_search

    mesh = pmesh.make_mesh((8, 1))
    dec = fl.init_params(jax.random.PRNGKey(0), CFG)
    k = 3
    feats = rng.standard_normal((8, k, E)).astype(np.float32)

    def one(feat):
        return beam_search(
            embed_fn=lambda t: fl.embed(dec, t),
            step_fn=lambda x, s: fl.decode_step(dec, x, s, jnp.asarray(0)),
            init_model_state=fl.initial_state(k, CFG),
            start_token=1, end_token=2, k=k, max_seq_length=8,
            vocab_size=V, first_input=feat)

    (feats_s,) = ptrain.place_batch(mesh, jnp.asarray(feats))
    res = jax.jit(jax.vmap(one))(feats_s)
    assert res.tokens.shape[0] == 8
    assert np.all(np.asarray(res.length) >= 1)


def test_multihost_data_helpers_single_host(rng):
    """shard_examples + make_array_from_process_local_data on the virtual
    mesh (single host: local slice == global batch, sharded over data)."""
    from icee_tpu.data.pipeline import make_batch
    from icee_tpu.parallel import data as pdata

    exs = list(range(10))
    assert pdata.shard_examples(exs, process_index=0, process_count=1) == exs
    # multi-process slicing math
    assert pdata.shard_examples(exs, 0, 3) == [0, 1, 2, 3]
    assert pdata.shard_examples(exs, 2, 3) == [8, 9]

    mesh = pmesh.make_mesh((8, 1))
    batch = make_batch([[1, 4, 2]] * 8, max_len=6, batch_size=8,
                       images=rng.standard_normal((8, FEAT)).astype(np.float32))
    g = pdata.global_caption_batch(mesh, batch)
    assert g["captions"].shape == (8, 6)
    assert "data" in str(g["captions"].sharding.spec)
    np.testing.assert_array_equal(np.asarray(g["lengths"]),
                                  batch.lengths)


@pytest.mark.parametrize("family", ["stylenet", "nic", "stylenet_att",
                                    "nic_att"])
def test_sharded_beam_decode_matches_single_device(rng, family):
    """Data-parallel beam decode over the 8-device mesh == the one-device
    decode, every family (independent per image, no collectives)."""
    from icee_tpu.core.config import AttentionDecoderConfig
    from icee_tpu.decode.fast import beam_fn, sharded_beam_fn
    from icee_tpu.models import attention as att_mod
    from icee_tpu.models import lstm as nic_mod

    common = dict(vocab_size=256, embed_size=16, hidden_size=32,
                  factored_size=32, feature_size=24, max_seq_length=6)
    att = family.endswith("_att")
    cfg = (AttentionDecoderConfig(attention_size=16, **common) if att
           else DecoderConfig(**common))
    init = {"stylenet": fl.init_params, "nic": nic_mod.init_params,
            "stylenet_att": att_mod.init_factored_att_params,
            "nic_att": att_mod.init_rnn_att_params}[family]
    dec = init(jax.random.PRNGKey(0), cfg)
    batch, k = 16, 3
    shape = (batch, 6, 24) if att else (batch, 16)
    feats = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    kw = dict(k=k, max_seq_length=6, vocab_size=256, start_token=1,
              end_token=2)

    mesh = pmesh.make_mesh((8, 1))
    got = sharded_beam_fn(family, dec, mesh, batch, **kw)(feats, 2)
    want = beam_fn(family, dec, batch, **kw)(feats, 2)
    np.testing.assert_array_equal(np.asarray(got.tokens),
                                  np.asarray(want.tokens))
    np.testing.assert_array_equal(np.asarray(got.length),
                                  np.asarray(want.length))
    assert "data" in str(got.tokens.sharding.spec)
