"""Device-resident whole-epoch training (``data/device.py`` +
``MultitaskTrainer._run_train_device``).

The device-resident epoch: the split pinned on device, one jitted ``lax.scan``
over shuffled batch-index rows per epoch (the captioner analogue of the
SentiCap Theano shared-array path, ``senticap/mrnn/mrnn.py:581-596``; the
reference captioners re-feed every batch from host workers,
``stylenet/train_multitask.py:364-408``).  Must visit the SAME batches in
the SAME order as the host ``BatchLoader`` and produce matching parameters.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icee_tpu.core.config import (
    AttentionDecoderConfig,
    DecoderConfig,
    EncoderConfig,
    TrainConfig,
)
from icee_tpu.data import build_vocab, load_caption_dataset
from icee_tpu.data import device as device_data
from icee_tpu.data.pipeline import caption_dataset_loader
from icee_tpu.models import attention as att_mod
from icee_tpu.models import encoder as enc_mod
from icee_tpu.models import factored_lstm as fl
from icee_tpu.parallel.mesh import make_mesh
from icee_tpu.train.loops import MultitaskTrainer

CORPUS = (
    "i1.jpg#0\tseorang anak bermain bola di lapangan\n"
    "i2.jpg#0\tseekor anjing coklat berlari cepat\n"
    "i3.jpg#0\tdua orang tua duduk di bangku\n"
    "i4.jpg#0\tseorang wanita muda membaca buku\n"
    "i5.jpg#0\tseorang pria berdiri di pantai\n"
    "i6.jpg#0\tseekor kucing tidur di atas meja\n"
    "i7.jpg#0\tanak anak berenang di sungai\n"
    "i8.jpg#0\tseorang petani bekerja di sawah\n"
    "i9.jpg#0\tseorang anak kecil tertawa riang\n"
    "i10.jpg#0\tseekor burung terbang di langit\n"
)
FEAT, B, MAXLEN = 16, 4, 12


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    p = tmp_path_factory.mktemp("dev_epoch")
    (p / "fac.txt").write_text(CORPUS)
    vocab = build_vocab(str(p / "fac.txt"), threshold=1)
    ds = load_caption_dataset(str(p / "fac.txt"), vocab)
    rng = np.random.default_rng(0)
    feats = {e.image: rng.standard_normal((FEAT,)).astype(np.float32)
             for e in ds}
    return vocab, ds, feats


def _trainer(vocab, tmp_path, mesh=None, family="factored", cfg=None,
             tag="t"):
    if cfg is None:
        cfg = DecoderConfig(vocab_size=len(vocab), embed_size=16,
                            hidden_size=24, factored_size=24, dropout=0.0,
                            max_seq_length=10)
    tcfg = TrainConfig(mode="happy", lr_caption=5e-3, lr_language=5e-3,
                       teacher_forcing_ratio=1.0, log_step=10_000,
                       log_step_emotion=10_000)
    attention = family.endswith("_att")
    if attention:
        dec = att_mod.init_factored_att_params(jax.random.PRNGKey(0), cfg)
        head = None
    else:
        dec = fl.init_params(jax.random.PRNGKey(0), cfg)
        head = enc_mod.init_head_params(
            jax.random.PRNGKey(1),
            EncoderConfig(embed_size=16, feature_size=FEAT))
    return MultitaskTrainer(cfg, tcfg, vocab, dec, head, family=family,
                            model_dir=str(tmp_path / f"m_{tag}"),
                            data_name="dev", mesh=mesh)


def test_epoch_indices_match_batch_loader(data):
    """Same seeded generator, same trailing partial batch, across epochs."""
    _, ds, feats = data
    loader = caption_dataset_loader(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], shuffle=True, seed=7, prefetch=0)
    ddata = device_data.from_examples(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], shuffle=True, seed=7)
    assert len(ddata) == len(loader) == 3  # 10 examples, B=4 -> 4+4+2
    for _ in range(2):  # two epochs: generators must stay in lockstep
        host = loader._index_batches()
        idx, valid = ddata.epoch_indices()
        for b, hb in enumerate(host):
            np.testing.assert_array_equal(idx[b, : len(hb)], hb)
            assert valid[b].sum() == len(hb)
            assert not valid[b, len(hb):].any()


@pytest.mark.parametrize("style", [0, 1])
def test_device_epoch_matches_host_loop(data, tmp_path, style):
    """One epoch through ``_run_train`` with a DeviceCaptionData equals the
    host-loader epoch: same batches, same RNG splits, matching params."""
    vocab, ds, feats = data

    def run(device):
        tr = _trainer(vocab, tmp_path, tag=f"host{device}{style}")
        if device:
            src = device_data.from_examples(
                ds, batch_size=B, max_len=MAXLEN,
                image_provider=lambda n: feats[n], shuffle=True, seed=3)
        else:
            src = caption_dataset_loader(
                ds, batch_size=B, max_len=MAXLEN,
                image_provider=lambda n: feats[n], shuffle=True, seed=3,
                prefetch=0)
        st = tr._run_train(src, style, 10_000, "T")
        return tr, st

    tr_h, st_h = run(False)
    tr_d, st_d = run(True)
    assert np.isfinite(st_d.loss)
    np.testing.assert_allclose(st_d.loss, st_h.loss, rtol=1e-6)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr_h.dec)[0],
            jax.tree_util.tree_flatten_with_path(tr_d.dec)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr_h.head)[0],
            jax.tree_util.tree_flatten_with_path(tr_d.head)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
            err_msg=f"head mismatch at {jax.tree_util.keystr(path)}")


def test_multiref_split_dedupes_features_and_matches_host(tmp_path):
    """5-ref splits pin ONE feature copy per unique image (image_index
    indirection, data/device.py) and the device epoch still bit-matches
    the host-loader epoch on the same multi-ref corpus."""
    lines = []
    base = CORPUS.strip().splitlines()
    for ln in base:
        name, cap = ln.split("\t")
        img = name.split("#")[0]
        words = cap.split()
        for r in range(5):  # 5 reference captions per image, all distinct
            lines.append(f"{img}#{r}\t{' '.join(words[:len(words) - r % 3])}")
    p = tmp_path / "multi.txt"
    p.write_text("\n".join(lines) + "\n")
    vocab = build_vocab(str(p), threshold=1)
    ds = load_caption_dataset(str(p), vocab)
    assert len(ds) == 50
    rng = np.random.default_rng(1)
    feats = {e.image: rng.standard_normal((FEAT,)).astype(np.float32)
             for e in ds}

    ddata = device_data.from_examples(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], shuffle=True, seed=3)
    assert ddata.images.shape[0] == 10          # unique images, not 50
    assert ddata.image_index.shape == (50,)
    idx, _ = ddata.epoch_indices()
    rows = ddata.image_rows(idx)
    # translated gather reproduces the per-example features exactly
    for b in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            np.testing.assert_array_equal(
                np.asarray(ddata.images)[rows[b, j]],
                feats[ds[int(idx[b, j])].image])

    def run(device):
        tr = _trainer(vocab, tmp_path, tag=f"dedupe{device}")
        if device:
            src = device_data.from_examples(
                ds, batch_size=B, max_len=MAXLEN,
                image_provider=lambda n: feats[n], shuffle=True, seed=3)
        else:
            src = caption_dataset_loader(
                ds, batch_size=B, max_len=MAXLEN,
                image_provider=lambda n: feats[n], shuffle=True, seed=3,
                prefetch=0)
        st = tr._run_train(src, 0, 10_000, "T")
        return tr, st

    tr_h, st_h = run(False)
    tr_d, st_d = run(True)
    np.testing.assert_allclose(st_d.loss, st_h.loss, rtol=1e-6)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr_h.dec)[0],
            jax.tree_util.tree_flatten_with_path(tr_d.dec)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")


def test_device_epoch_attention_family(data, tmp_path):
    """The head-less attention families run the device epoch too (spatial
    features, emotion track)."""
    vocab, ds, _ = data
    cfg = AttentionDecoderConfig(
        vocab_size=len(vocab), embed_size=16, hidden_size=24,
        factored_size=24, attention_size=16, feature_size=FEAT, dropout=0.0,
        max_seq_length=10)
    rng = np.random.default_rng(1)
    sp_feats = {e.image: rng.standard_normal((5, FEAT)).astype(np.float32)
                for e in ds}

    def run(device):
        tr = _trainer(vocab, tmp_path, family="factored_att", cfg=cfg,
                      tag=f"att{device}")
        if device:
            src = device_data.from_examples(
                ds, batch_size=B, max_len=MAXLEN,
                image_provider=lambda n: sp_feats[n], shuffle=True, seed=5)
        else:
            src = caption_dataset_loader(
                ds, batch_size=B, max_len=MAXLEN,
                image_provider=lambda n: sp_feats[n], shuffle=True, seed=5,
                prefetch=0)
        st = tr._run_train(src, 1, 10_000, "HAP")
        return tr, st

    tr_h, st_h = run(False)
    tr_d, st_d = run(True)
    np.testing.assert_allclose(st_d.loss, st_h.loss, rtol=1e-6)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr_h.dec)[0],
            jax.tree_util.tree_flatten_with_path(tr_d.dec)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")


def test_device_epoch_full_factual_training(data, tmp_path):
    """train_factual_only drives device-resident train epochs end-to-end
    (train scan + host val + BLEU + checkpointing)."""
    vocab, ds, feats = data
    tr = _trainer(vocab, tmp_path, tag="full")
    ddata = device_data.from_examples(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], shuffle=True, seed=0)
    val = caption_dataset_loader(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], shuffle=False, seed=0, prefetch=0)
    out = tr.train_factual_only(ddata, val, num_epochs=2)
    assert np.isfinite(out["best_bleu4"]["factual"])


def test_device_epoch_transfer_trainer(data, tmp_path):
    """TransferTrainer (masked style-only optimizer) inherits the device
    epoch: emotion-track scan updates ONLY the style group, matching the
    host loop."""
    from icee_tpu.train.loops import TransferTrainer

    vocab, ds, feats = data
    cfg = DecoderConfig(vocab_size=len(vocab), embed_size=16,
                        hidden_size=24, factored_size=24, dropout=0.0,
                        max_seq_length=10)
    tcfg = TrainConfig(mode="happy", lr_caption=5e-3, lr_language=5e-3,
                       teacher_forcing_ratio=1.0, log_step=10_000,
                       log_step_emotion=10_000)

    def run(device):
        dec = fl.init_params(jax.random.PRNGKey(0), cfg)
        head = enc_mod.init_head_params(
            jax.random.PRNGKey(1), EncoderConfig(embed_size=16,
                                                 feature_size=FEAT))
        tr = TransferTrainer(cfg, tcfg, vocab, dec, head,
                             model_dir=str(tmp_path / f"tx{device}"),
                             data_name="dev")
        if device:
            src = device_data.from_examples(
                ds, batch_size=B, max_len=MAXLEN,
                image_provider=lambda n: feats[n], shuffle=True, seed=9)
        else:
            src = caption_dataset_loader(
                ds, batch_size=B, max_len=MAXLEN,
                image_provider=lambda n: feats[n], shuffle=True, seed=9,
                prefetch=0)
        st = tr._run_train(src, 1, 10_000, "HAP")
        return tr, st

    tr_h, st_h = run(False)
    tr_d, st_d = run(True)
    np.testing.assert_allclose(st_d.loss, st_h.loss, rtol=1e-6)
    leaves_h = jax.tree_util.tree_flatten_with_path(tr_h.dec)[0]
    leaves_d = jax.tree_util.tree_flatten_with_path(tr_d.dec)[0]
    for (path, a), (_, b) in zip(leaves_h, leaves_d):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")
    # the masked optimizer must have left non-style params at init values
    init = fl.init_params(jax.random.PRNGKey(0), cfg)
    np.testing.assert_array_equal(np.asarray(tr_d.dec["B"]),
                                  np.asarray(init["B"]))
    np.testing.assert_array_equal(np.asarray(tr_d.dec["V_w"]),
                                  np.asarray(init["V_w"]))


def test_device_epoch_on_mesh_matches_single(data, tmp_path):
    """Device-resident epochs under the 8-device DP mesh: gathered batches
    reshard over the data axis; params match the single-device device-epoch
    run up to cross-device reduction reassociation."""
    vocab, ds, feats = data

    def run(mesh):
        tr = _trainer(vocab, tmp_path, mesh=mesh,
                      tag=f"mesh{mesh is not None}")
        ddata = device_data.from_examples(
            ds, batch_size=8, max_len=MAXLEN,
            image_provider=lambda n: feats[n], shuffle=True, seed=2,
            mesh=mesh)
        st = tr._run_train(ddata, 0, 10_000, "FAC")
        return tr, st

    tr_s, st_s = run(None)
    tr_m, st_m = run(make_mesh((8, 1)))
    np.testing.assert_allclose(st_m.loss, st_s.loss, rtol=2e-3)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr_s.dec)[0],
            jax.tree_util.tree_flatten_with_path(tr_m.dec)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=2e-3, atol=5e-4,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")


def test_device_val_matches_host(data, tmp_path):
    """_run_val over a DeviceCaptionData: loss/top-5/BLEU-4 equal the host
    val loop on the same (unshuffled) split."""
    vocab, ds, feats = data
    tr = _trainer(vocab, tmp_path, tag="val")
    host = caption_dataset_loader(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], shuffle=False, seed=0, prefetch=0)
    dev = device_data.from_examples(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], shuffle=False, seed=0)
    va_h = tr._run_val(host, 0)
    va_d = tr._run_val(dev, 0)
    np.testing.assert_allclose(va_d.loss, va_h.loss, rtol=1e-6)
    np.testing.assert_allclose(va_d.top5, va_h.top5, rtol=1e-6)
    np.testing.assert_allclose(va_d.bleu4, va_h.bleu4, rtol=1e-9)


def test_device_val_attention_family(data, tmp_path):
    """Attention-family device val (shifted hypotheses, no head)."""
    vocab, ds, _ = data
    cfg = AttentionDecoderConfig(
        vocab_size=len(vocab), embed_size=16, hidden_size=24,
        factored_size=24, attention_size=16, feature_size=FEAT, dropout=0.0,
        max_seq_length=10)
    rng = np.random.default_rng(1)
    sp_feats = {e.image: rng.standard_normal((5, FEAT)).astype(np.float32)
                for e in ds}
    tr = _trainer(vocab, tmp_path, family="factored_att", cfg=cfg,
                  tag="valatt")
    host = caption_dataset_loader(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: sp_feats[n], shuffle=False, seed=0,
        prefetch=0)
    dev = device_data.from_examples(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: sp_feats[n], shuffle=False, seed=0)
    va_h = tr._run_val(host, 1)
    va_d = tr._run_val(dev, 1)
    np.testing.assert_allclose(va_d.loss, va_h.loss, rtol=1e-6)
    np.testing.assert_allclose(va_d.top5, va_h.top5, rtol=1e-6)
    np.testing.assert_allclose(va_d.bleu4, va_h.bleu4, rtol=1e-9)


def test_fits_device_gate():
    assert device_data.fits_device(8000, (2048,))           # 66 MB pooled
    assert not device_data.fits_device(30000, (196, 2048))  # 48 GB spatial


def test_device_style_epoch_paper_trainer(data, tmp_path):
    """PaperRegimeTrainer's text-only style passes over a device-resident
    corpus (``from_styled``): one scan per emotion epoch, params matching
    the host styled-loader loop bit-for-bit."""
    from icee_tpu.data.pipeline import styled_caption_loader
    from icee_tpu.train.loops import PaperRegimeTrainer

    vocab, ds, feats = data
    cfg = DecoderConfig(vocab_size=len(vocab), embed_size=16,
                        hidden_size=24, factored_size=24, dropout=0.0,
                        max_seq_length=10)
    tcfg = TrainConfig(mode="happy", lr_caption=5e-3, lr_language=5e-3,
                       teacher_forcing_ratio=1.0, log_step=10_000,
                       log_step_emotion=10_000)
    style_ids = [e.caption_ids for e in ds]

    def run_seeded(device):
        fl_fac = caption_dataset_loader(
            ds, batch_size=B, max_len=MAXLEN,
            image_provider=lambda n: feats[n], shuffle=True, seed=11,
            prefetch=0)
        tr = PaperRegimeTrainer(
            cfg, tcfg, vocab, fl.init_params(jax.random.PRNGKey(0), cfg),
            enc_mod.init_head_params(
                jax.random.PRNGKey(1),
                EncoderConfig(embed_size=16, feature_size=FEAT)),
            model_dir=str(tmp_path / f"pp{device}"), data_name="dev")
        if device:
            mk = lambda: device_data.from_styled(  # noqa: E731
                style_ids, batch_size=B, max_len=MAXLEN, seed=13)
        else:
            mk = lambda: styled_caption_loader(  # noqa: E731
                style_ids, batch_size=B, max_len=MAXLEN, seed=13, prefetch=0)
        tr.train(fl_fac, {"happy": mk(), "sad": mk()}, num_epochs=1)
        return tr

    tr_h = run_seeded(False)
    tr_d = run_seeded(True)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr_h.dec)[0],
            jax.tree_util.tree_flatten_with_path(tr_d.dec)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")


def test_device_epoch_seq2seq_trainer(data, tmp_path):
    """Seq2SeqTrainer: device-resident factual + emotion train epochs and
    both validation passes match the host loops (params + metrics)."""
    from icee_tpu.core.config import Seq2SeqConfig
    from icee_tpu.models import seq2seq as s2s
    from icee_tpu.train.loops import Seq2SeqTrainer

    vocab, ds, feats = data
    scfg = Seq2SeqConfig(vocab_size=len(vocab), embed_size=16,
                         hidden_size=24, num_layers=1, dropout=0.0,
                         max_seq_length=10)
    tcfg = TrainConfig(lr_caption=5e-3, lr_language=5e-3,
                       teacher_forcing_ratio=1.0)

    def mk_loader(device, seed, shuffle=True):
        if device:
            return device_data.from_examples(
                ds, batch_size=B, max_len=MAXLEN,
                image_provider=lambda n: feats[n], shuffle=shuffle,
                seed=seed)
        return caption_dataset_loader(
            ds, batch_size=B, max_len=MAXLEN,
            image_provider=lambda n: feats[n], shuffle=shuffle, seed=seed,
            prefetch=0)

    def run(device):
        params = s2s.init_params(jax.random.PRNGKey(0), scfg)
        head = enc_mod.init_head_params(
            jax.random.PRNGKey(1), EncoderConfig(embed_size=16,
                                                 feature_size=FEAT))
        tr = Seq2SeqTrainer(scfg, tcfg, vocab, params, head)
        tr.train(mk_loader(device, 21),
                 {"happy": mk_loader(device, 22)}, num_epochs=1)
        vf = tr.validate_factual(mk_loader(device, 0, shuffle=False))
        ve = tr.validate_emotion(mk_loader(device, 0, shuffle=False), 0)
        return tr, vf, ve

    tr_h, vf_h, ve_h = run(False)
    tr_d, vf_d, ve_d = run(True)
    np.testing.assert_allclose(vf_d, vf_h, rtol=1e-6)
    np.testing.assert_allclose(ve_d, ve_h, rtol=1e-6)
    for tree_h, tree_d, tag in ((tr_h.params, tr_d.params, "params"),
                                (tr_h.head, tr_d.head, "head")):
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(tree_h)[0],
                jax.tree_util.tree_flatten_with_path(tree_d)[0]):
            np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
                err_msg=f"{tag} mismatch at {jax.tree_util.keystr(path)}")


def test_device_epoch_seq2seq_on_mesh(data, tmp_path):
    """Seq2Seq device-resident epochs under the 8-device DP mesh match the
    single-device device-epoch run (gathered batches reshard over the data
    axis; GSPMD inserts the gradient psum)."""
    from icee_tpu.core.config import Seq2SeqConfig
    from icee_tpu.models import seq2seq as s2s
    from icee_tpu.train.loops import Seq2SeqTrainer

    vocab, ds, feats = data
    scfg = Seq2SeqConfig(vocab_size=len(vocab), embed_size=16,
                         hidden_size=24, num_layers=1, dropout=0.0,
                         max_seq_length=10)
    tcfg = TrainConfig(lr_caption=5e-3, lr_language=5e-3,
                       teacher_forcing_ratio=1.0)

    def run(mesh):
        params = s2s.init_params(jax.random.PRNGKey(0), scfg)
        head = enc_mod.init_head_params(
            jax.random.PRNGKey(1), EncoderConfig(embed_size=16,
                                                 feature_size=FEAT))
        tr = Seq2SeqTrainer(scfg, tcfg, vocab, params, head, mesh=mesh)
        dl = device_data.from_examples(
            ds, batch_size=8, max_len=MAXLEN,
            image_provider=lambda n: feats[n], shuffle=True, seed=4,
            mesh=mesh)
        el = device_data.from_examples(
            ds, batch_size=8, max_len=MAXLEN,
            image_provider=lambda n: feats[n], shuffle=True, seed=5,
            mesh=mesh)
        tr.train(dl, {"happy": el}, num_epochs=1)
        vl = device_data.from_examples(
            ds, batch_size=8, max_len=MAXLEN,
            image_provider=lambda n: feats[n], shuffle=False, seed=0,
            mesh=mesh)
        return tr, tr.validate_factual(vl)

    tr_s, vf_s = run(None)
    tr_m, vf_m = run(make_mesh((8, 1)))
    np.testing.assert_allclose(vf_m, vf_s, rtol=2e-3, atol=1e-5)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr_s.params)[0],
            jax.tree_util.tree_flatten_with_path(tr_m.params)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=2e-3, atol=5e-4,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")


# -- pinned-per-batch tier (round 5: the whole-epoch scan program copies --
# -- the pinned feature array into the XLA while-loop state, so splits   --
# -- between budget/2 and budget dispatch per batch instead; pin_plan    --


def test_pin_plan_tiers():
    per = 196 * 2048 * 4
    budget = 10 * per
    assert device_data.pin_plan(5, (196, 2048), budget) == "epoch"
    assert device_data.pin_plan(8, (196, 2048), budget) == "per_batch"
    assert device_data.pin_plan(11, (196, 2048), budget) == "stream"


def test_gather_rows_matches_take():
    """The copy-free vmapped dynamic_slice gather is value-identical to
    jnp.take (incl. repeated rows)."""
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((7, 3, 5)).astype(np.float32))
    rows = jnp.asarray([0, 6, 2, 2], jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(device_data.gather_rows(a, rows)),
        np.asarray(jnp.take(a, rows, axis=0)))


@pytest.mark.parametrize("style", [0, 1])
def test_per_batch_epoch_matches_scan(data, tmp_path, style):
    """The pinned-per-batch tier trains numerically identically to the
    whole-epoch scan program (same batches, same RNG chain; only the
    dispatch boundaries differ)."""
    vocab, ds, feats = data

    def run(per_batch):
        tr = _trainer(vocab, tmp_path, tag=f"pb{per_batch}{style}")
        src = device_data.from_examples(
            ds, batch_size=B, max_len=MAXLEN,
            image_provider=lambda n: feats[n], shuffle=True, seed=3,
            per_batch=per_batch)
        st = tr._run_train(src, style, 10_000, "T")
        return tr, st

    tr_s, st_s = run(False)
    tr_b, st_b = run(True)
    assert np.isfinite(st_b.loss)
    np.testing.assert_allclose(st_b.loss, st_s.loss, rtol=1e-6)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr_s.dec)[0],
            jax.tree_util.tree_flatten_with_path(tr_b.dec)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr_s.head)[0],
            jax.tree_util.tree_flatten_with_path(tr_b.head)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
            err_msg=f"head mismatch at {jax.tree_util.keystr(path)}")


def test_per_batch_val_matches_scan(data, tmp_path):
    """_run_val over a per-batch split: metrics equal the whole-epoch val
    program (and hence the host loop, test_device_val_matches_host)."""
    vocab, ds, feats = data
    tr = _trainer(vocab, tmp_path, tag="pbval")

    def mk(per_batch):
        return device_data.from_examples(
            ds, batch_size=B, max_len=MAXLEN,
            image_provider=lambda n: feats[n], shuffle=False, seed=0,
            per_batch=per_batch)

    va_s = tr._run_val(mk(False), 0)
    va_b = tr._run_val(mk(True), 0)
    np.testing.assert_allclose(va_b.loss, va_s.loss, rtol=1e-6)
    np.testing.assert_allclose(va_b.top5, va_s.top5, rtol=1e-6)
    np.testing.assert_allclose(va_b.bleu4, va_s.bleu4, rtol=1e-9)


def test_per_batch_attention_family(data, tmp_path):
    """Per-batch tier through the attention family (the design-point
    workload: spatial features too big to scan-copy)."""
    vocab, ds, _ = data
    cfg = AttentionDecoderConfig(
        vocab_size=len(vocab), embed_size=16, hidden_size=24,
        factored_size=24, attention_size=16, feature_size=FEAT, dropout=0.0,
        max_seq_length=10)
    rng = np.random.default_rng(1)
    sp_feats = {e.image: rng.standard_normal((5, FEAT)).astype(np.float32)
                for e in ds}

    def run(per_batch):
        tr = _trainer(vocab, tmp_path, family="factored_att", cfg=cfg,
                      tag=f"pbatt{per_batch}")
        src = device_data.from_examples(
            ds, batch_size=B, max_len=MAXLEN,
            image_provider=lambda n: sp_feats[n], shuffle=True, seed=3,
            per_batch=per_batch)
        st = tr._run_train(src, 1, 10_000, "T")
        return tr, st

    tr_s, st_s = run(False)
    tr_b, st_b = run(True)
    np.testing.assert_allclose(st_b.loss, st_s.loss, rtol=1e-6)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr_s.dec)[0],
            jax.tree_util.tree_flatten_with_path(tr_b.dec)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")


def test_per_batch_on_mesh_matches_single(data, tmp_path):
    """The per-batch tier under the 8-device DP mesh: each no-scan batch
    dispatch reshards its gathered batch over the data axis, matching the
    single-device per-batch run up to cross-device reduction
    reassociation (same tolerance as the scan-program mesh test)."""
    vocab, ds, feats = data

    def run(mesh):
        tr = _trainer(vocab, tmp_path, mesh=mesh,
                      tag=f"pbmesh{mesh is not None}")
        ddata = device_data.from_examples(
            ds, batch_size=8, max_len=MAXLEN,
            image_provider=lambda n: feats[n], shuffle=True, seed=2,
            mesh=mesh, per_batch=True)
        st = tr._run_train(ddata, 0, 10_000, "FAC")
        return tr, st

    tr_s, st_s = run(None)
    tr_m, st_m = run(make_mesh((8, 1)))
    np.testing.assert_allclose(st_m.loss, st_s.loss, rtol=2e-3)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tr_s.dec)[0],
            jax.tree_util.tree_flatten_with_path(tr_m.dec)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=2e-3, atol=5e-4,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")


def test_bf16_feature_storage_matches_f32(data, tmp_path):
    """bf16 feature storage (half the HBM wall per tier): on features
    already representable in bf16, training is identical to f32 storage —
    the epoch program's cast back to f32 restores the exact values."""
    import ml_dtypes

    vocab, ds, feats = data
    rfeats = {k: v.astype(ml_dtypes.bfloat16).astype(np.float32)
              for k, v in feats.items()}

    def run(fdt, per_batch):
        tr = _trainer(vocab, tmp_path, tag=f"fdt{fdt}{per_batch}")
        src = device_data.from_examples(
            ds, batch_size=B, max_len=MAXLEN,
            image_provider=lambda n: rfeats[n], shuffle=True, seed=3,
            per_batch=per_batch, feature_dtype=fdt)
        st = tr._run_train(src, 0, 10_000, "T")
        return tr, st

    tr_f, st_f = run(None, False)
    for per_batch in (False, True):
        tr_b, st_b = run(ml_dtypes.bfloat16, per_batch)
        np.testing.assert_allclose(st_b.loss, st_f.loss, rtol=1e-6)
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(tr_f.dec)[0],
                jax.tree_util.tree_flatten_with_path(tr_b.dec)[0]):
            np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
                err_msg=f"param mismatch at {jax.tree_util.keystr(path)} "
                        f"(per_batch={per_batch})")


def test_pin_plan_bf16_halves_walls():
    per_f32 = 196 * 2048 * 4
    budget = 10 * per_f32
    # 11 images stream in f32 but pin whole-epoch in bf16 (22 half-images
    # = 11 f32-equivalents > budget... 2*11*per/2 = 11*per > 10*per? no:
    # epoch needs 2x11x(per/2) = 11 per_f32 > budget -> per_batch)
    assert device_data.pin_plan(11, (196, 2048), budget) == "stream"
    assert device_data.pin_plan(
        11, (196, 2048), budget, bytes_per_feature=2) == "per_batch"
    assert device_data.pin_plan(
        9, (196, 2048), budget, bytes_per_feature=2) == "epoch"


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("platform,stats,want", [
    ("gpu", {"bytes_limit": 60 << 30}, 15 << 30),   # a quarter of it
    ("gpu", None, device_data.CPU_BUDGET_BYTES),     # no stats reported
    ("cpu", {"bytes_limit": 60 << 30}, device_data.CPU_BUDGET_BYTES),
])
def test_default_budget_bytes(platform, stats, want):
    got = device_data.default_budget_bytes(_FakeDevice(platform, stats))
    assert got == want
