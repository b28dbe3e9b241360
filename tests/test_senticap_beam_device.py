"""Device-side SentiCap beam (VERDICT r2 #5): the whole-search jitted
``lax.scan`` program must reproduce the host-driven oracle loop token-exactly
(scores, sequences, attention traces) for both the base mRNN and the
switched model.  Reference algorithm: ``mrnn_algorithms.py:114-209``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icee_tpu.senticap import model as M
from icee_tpu.senticap import switched as SW
from icee_tpu.senticap.beam import beam_decode, make_device_beam
from icee_tpu.senticap.config import senticap_conf
from icee_tpu.senticap.train import make_beam_step

VOCAB = 40
CONF = senticap_conf(emb_size=12, lstm_hidden_size=12, visual_size=8,
                     MAX_SENTENCE_LEN=9)


def _host(make, width, v_row, senti, beam, max_len, with_att=False):
    step = make(senti)

    def one(words, use_v, h, c):
        b = len(words)
        h_in = jnp.zeros((b, width)) if h is None else jnp.asarray(h)
        c_in = jnp.zeros((b, width)) if c is None else jnp.asarray(c)
        return step(jnp.asarray(np.asarray(words)), jnp.asarray(use_v),
                    h_in, c_in, jnp.asarray(v_row))

    return beam_decode(one, v_row, beam, max_len, with_attention=with_att)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_beam_matches_host_base_model(rng, seed):
    params = M.init_params(jax.random.PRNGKey(seed), VOCAB, CONF)
    v_row = rng.standard_normal((8,)).astype(np.float32)
    make = make_beam_step(params, CONF, switched=False)
    beam, max_len = 5, CONF["MAX_SENTENCE_LEN"]

    want = _host(make, CONF["lstm_hidden_size"], v_row, -1.0, beam, max_len)
    dec = make_device_beam(make(-1.0), CONF["lstm_hidden_size"], beam,
                           max_len)
    got = dec(v_row)
    assert got[1] == want[1], (got, want)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)


@pytest.mark.parametrize("senti", [1.0, -1.0])
def test_device_beam_matches_host_switched(rng, senti):
    params = SW.init_params(jax.random.PRNGKey(3), VOCAB, CONF)
    v_row = rng.standard_normal((8,)).astype(np.float32)
    make = make_beam_step(params, CONF, switched=True)
    width = 2 * CONF["lstm_hidden_size"]
    beam, max_len = 4, CONF["MAX_SENTENCE_LEN"]

    want = _host(make, width, v_row, senti, beam, max_len, with_att=True)
    dec = make_device_beam(make(senti), width, beam, max_len,
                           with_attention=True)
    got = dec(v_row)
    assert got[1] == want[1], (got, want)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)


def test_device_beam_vmaps_over_images(rng):
    """The raw run fn vmaps over a feature batch — single-dispatch test-set
    decoding — and each row matches the per-image device decode."""
    params = M.init_params(jax.random.PRNGKey(4), VOCAB, CONF)
    make = make_beam_step(params, CONF, switched=False)
    dec = make_device_beam(make(-1.0), CONF["lstm_hidden_size"], 4,
                           CONF["MAX_SENTENCE_LEN"])
    vs = rng.standard_normal((3, 8)).astype(np.float32)
    scs, seqs, lens, _ = jax.jit(jax.vmap(dec.run))(jnp.asarray(vs))
    for i in range(3):
        sc, words = dec(vs[i])
        assert words == [int(w) for w in np.asarray(seqs[i])[:int(lens[i])]]
        np.testing.assert_allclose(float(scs[i]), sc, rtol=1e-6)


def test_decode_split_device_matches_host(rng):
    """The test path (train_joint.py run_load_gap_filler) produces identical
    output through the device beam and the host oracle."""
    from icee_tpu.senticap import io as sio
    from icee_tpu.senticap.train import decode_split

    params = SW.init_params(jax.random.PRNGKey(5), VOCAB, CONF)
    n = 3
    ds = sio.SentiDataset(
        X=np.zeros((n, 11), np.int32), Y=np.zeros((n, 11), np.int32),
        Xlen=np.ones((n, 11), np.float32),
        V=rng.standard_normal((n, 8)).astype(np.float32),
        SW=np.zeros((n, 11), np.float32),
        senti=np.ones((n,), np.float32),
        ids=[f"im{i}" for i in range(n)])
    i2w = {i: f"w{i}" for i in range(VOCAB)}

    got = decode_split(params, CONF, ds, i2w, switched=True, beam_size=4,
                       device=True)
    want = decode_split(params, CONF, ds, i2w, switched=True, beam_size=4,
                        device=False)
    for g, w in zip(got, want):
        assert g["positive"] == w["positive"]
        assert g["descriptive"] == w["descriptive"]
        np.testing.assert_allclose(g["attention"], w["attention"],
                                   rtol=1e-5, atol=1e-6)
