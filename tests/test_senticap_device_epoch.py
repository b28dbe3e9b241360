"""SentiCap whole-epoch device-resident training (``senticap/train.py``,
``make_base_epoch`` / ``make_switched_epoch``).

The reference's epoch is N compiled ``train(indx)`` calls over Theano
shared arrays (``senticap/mrnn/mrnn.py:727-770``); the device-resident epoch
collapses those N dispatches into ONE jitted ``lax.scan`` over the epoch's
(n_batches, batch) index matrix.  The scan carries the PRNG key and splits
it exactly like the host loop, so parameters, optimizer state, and the
per-batch loss stream must BIT-MATCH the per-batch path.
"""

import numpy as np
import jax
import pytest

from icee_tpu.senticap import io as sio
from icee_tpu.senticap import train as T
from icee_tpu.senticap.config import senticap_conf


def _records(n, mixed=False):
    sents = [["a", "dog", "runs", "fast"],
             ["the", "cat", "sits", "still"],
             ["a", "happy", "dog", "plays"],
             ["sad", "cat", "sleeps"]]
    recs = []
    for i in range(n):
        recs.append({
            "image": f"img{i % 4}",
            "tokens": sents[i % 4],
            "sentiment": (1.0 if (i % 2 == 0) else -1.0) if mixed else 1.0,
            "switch": [0, 1, 0, 0],
        })
    return recs


def _dataset(n=12, mixed=False, seed=0):
    rng = np.random.default_rng(seed)
    recs = _records(n, mixed)
    w2i, i2w = sio.build_vocab([r["tokens"] for r in recs], min_freq=1)
    feats = {f"img{j}": rng.standard_normal((8,)).astype(np.float32) * 0.1
             for j in range(4)}
    ds = sio.make_split(recs, feats, w2i, max_len=6, visual_size=8)
    return ds, w2i


def _conf(**kw):
    base = dict(emb_size=16, lstm_hidden_size=16, visual_size=8,
                batch_size_val=4, MAX_SENTENCE_LEN=6, learning_rate=0.01)
    base.update(kw)
    return senticap_conf(**base)


def _tree_equal(a, b):
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(la, lb))


def test_base_device_epoch_bitmatches_host_loop():
    ds, w2i = _dataset()
    conf = _conf()
    host, _ = T.train_base(ds, len(w2i), conf, num_epochs=2, seed=3)
    dev, _ = T.train_base(ds, len(w2i), conf, num_epochs=2, seed=3,
                          device_epoch=True)
    assert _tree_equal(host, dev)


def test_base_device_epoch_semi_forced():
    ds, w2i = _dataset()
    conf = _conf(SEMI_FORCED=0.7)
    host, _ = T.train_base(ds, len(w2i), conf, num_epochs=1, seed=5)
    dev, _ = T.train_base(ds, len(w2i), conf, num_epochs=1, seed=5,
                          device_epoch=True)
    assert _tree_equal(host, dev)


@pytest.mark.parametrize("domain_adapt", ["da_sum", "da_similar_param_3"])
def test_switched_device_epoch_bitmatches_host_loop(domain_adapt):
    ds, w2i = _dataset(n=16, mixed=True)
    conf = _conf(DOMAIN_ADAPT=domain_adapt)
    from icee_tpu.senticap import model as base_model

    base = base_model.init_params(jax.random.PRNGKey(0), len(w2i), conf)
    host, _ = T.train_switched(ds, base, len(w2i), conf, num_epochs=2,
                               seed=7)
    dev, _ = T.train_switched(ds, base, len(w2i), conf, num_epochs=2,
                              seed=7, device_epoch=True)
    assert _tree_equal(host, dev)


def test_switched_device_epoch_on_mesh_matches_single():
    """DP mesh + whole-epoch scan = single-device whole-epoch scan."""
    from icee_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU mesh")
    ds, w2i = _dataset(n=16, mixed=True)
    conf = _conf()
    from icee_tpu.senticap import model as base_model

    base = base_model.init_params(jax.random.PRNGKey(0), len(w2i), conf)
    single, _ = T.train_switched(ds, base, len(w2i), conf, num_epochs=1,
                                 seed=1, device_epoch=True)
    mesh = make_mesh()
    meshed, _ = T.train_switched(ds, base, len(w2i), conf, num_epochs=1,
                                 seed=1, device_epoch=True, mesh=mesh)
    la = jax.tree_util.tree_leaves(single)
    lb = jax.tree_util.tree_leaves(meshed)
    for x, y in zip(la, lb):
        # f32 reduction-order noise only (DP psum vs single-device sums),
        # amplified through the epoch's optimizer-update chain
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-4, atol=1e-5)
