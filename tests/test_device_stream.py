"""Chunk-streamed device epochs for HBM-oversized splits
(``data/device.py`` ``StreamedCaptionData`` +
``MultitaskTrainer._run_train_streamed``).

Splits whose features fail the ``fits_device`` pin gate (e.g. full-Flickr8k
spatial attention features, ~6k unique images x 1.6 MB) used to fall back to
the per-batch host loader — two dispatches per batch.  The
streamed path keeps the EXACT epoch composition of the pinned device epoch
(same seeded shuffle, same trailing partial batch, same RNG split order) but
features stream per chunk of batch rows: each chunk's unique images are
deduplicated into a fixed-``capacity`` buffer (one compiled program for every
chunk) and the next buffer's host gather + transfer overlap the current
chunk's compute.  Parameters must bit-match the pinned epoch and therefore
the host ``BatchLoader`` loop (`test_device_epoch.py` closes that leg).

Reference context: the reference has no oversized-split story at all — its
DataLoader re-reads images per batch (``stylenet/train_multitask.py:364-408``).
"""

import numpy as np
import jax
import pytest

from icee_tpu.core.config import (
    AttentionDecoderConfig,
    DecoderConfig,
    EncoderConfig,
    TrainConfig,
)
from icee_tpu.data import build_vocab, load_caption_dataset
from icee_tpu.data import device as device_data
from icee_tpu.models import attention as att_mod
from icee_tpu.models import encoder as enc_mod
from icee_tpu.models import factored_lstm as fl
from icee_tpu.parallel.mesh import make_mesh
from icee_tpu.train.loops import MultitaskTrainer

FEAT, B, MAXLEN = 16, 4, 12

CORPUS_LINES = [
    "seorang anak bermain bola di lapangan",
    "seekor anjing coklat berlari cepat",
    "dua orang tua duduk di bangku",
    "seorang wanita muda membaca buku",
    "seorang pria berdiri di pantai",
    "seekor kucing tidur di atas meja",
    "anak anak berenang di sungai",
    "seorang petani bekerja di sawah",
    "seorang anak kecil tertawa riang",
    "seekor burung terbang di langit",
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # 5-ref-per-image corpus: the dedup/remap paths must handle repeated
    # unique rows inside and across chunks
    p = tmp_path_factory.mktemp("dev_stream")
    lines = []
    for i, cap in enumerate(CORPUS_LINES):
        words = cap.split()
        for r in range(5):
            lines.append(
                f"i{i}.jpg#{r}\t{' '.join(words[:len(words) - r % 3])}")
    (p / "fac.txt").write_text("\n".join(lines) + "\n")
    vocab = build_vocab(str(p / "fac.txt"), threshold=1)
    ds = load_caption_dataset(str(p / "fac.txt"), vocab)
    assert len(ds) == 50
    rng = np.random.default_rng(0)
    feats = {e.image: rng.standard_normal((FEAT,)).astype(np.float32)
             for e in ds}
    return vocab, ds, feats


def _trainer(vocab, tmp_path, mesh=None, family="factored", cfg=None,
             tag="t", progress_chunk=0):
    if cfg is None:
        cfg = DecoderConfig(vocab_size=len(vocab), embed_size=16,
                            hidden_size=24, factored_size=24, dropout=0.0,
                            max_seq_length=10)
    tcfg = TrainConfig(mode="happy", lr_caption=5e-3, lr_language=5e-3,
                       teacher_forcing_ratio=1.0, log_step=10_000,
                       log_step_emotion=10_000, progress_chunk=progress_chunk)
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


def _streamed(ds, feats, seed, capacity, shuffle=True, mesh=None,
              feature_of=None):
    provider = feature_of or (lambda n: feats[n])
    sd = device_data.from_examples_streamed(
        ds, batch_size=B, max_len=MAXLEN, image_provider=provider,
        shuffle=shuffle, seed=seed, mesh=mesh,
        budget_bytes=3 * capacity * int(
            np.asarray(provider(ds[0].image)).nbytes))
    assert sd.capacity == min(capacity, sd.host_features.shape[0])
    return sd


def _pinned(ds, feats, seed, shuffle=True, mesh=None, feature_of=None):
    provider = feature_of or (lambda n: feats[n])
    return device_data.from_examples(
        ds, batch_size=B, max_len=MAXLEN, image_provider=provider,
        shuffle=shuffle, seed=seed, mesh=mesh)


def _assert_trees_close(a_tree, b_tree, **kw):
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(a_tree)[0],
            jax.tree_util.tree_flatten_with_path(b_tree)[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a),
            err_msg=f"mismatch at {jax.tree_util.keystr(path)}", **kw)


def test_chunk_features_remap_exact(data):
    """chunk_features: the compact buffer + remap reproduce the original
    per-slot features exactly; over-capacity chunks are rejected."""
    _, ds, feats = data
    sd = _streamed(ds, feats, seed=3, capacity=2 * B)
    idx, valid = sd.epoch_indices()
    rows = sd.image_rows(idx)
    R = sd.rows_per_chunk
    assert R == 2
    for r0 in range(0, idx.shape[0], R):
        chunk_rows = rows[r0:r0 + R]
        buf, remap = sd.chunk_features(chunk_rows)
        assert buf.shape == (sd.capacity, FEAT)
        assert remap.shape == chunk_rows.shape
        assert remap.max() < sd.capacity
        for b in range(chunk_rows.shape[0]):
            for j in range(chunk_rows.shape[1]):
                np.testing.assert_array_equal(
                    buf[remap[b, j]], sd.host_features[chunk_rows[b, j]])
    with pytest.raises(ValueError):
        # 9 distinct unique rows cannot fit a capacity-8 buffer
        sd.chunk_features(np.arange(9).reshape(1, 9))


@pytest.mark.parametrize("style", [0, 1])
def test_streamed_epoch_matches_pinned(data, tmp_path, style):
    """A streamed epoch (3+ chunks, tail chunk included) produces the same
    parameters and loss as the pinned device epoch — and by
    test_device_epoch.py's host-equivalence, as the host loader loop."""
    vocab, ds, feats = data

    def run(streamed):
        tr = _trainer(vocab, tmp_path, tag=f"s{streamed}{style}")
        src = (_streamed(ds, feats, seed=3, capacity=5 * B) if streamed
               else _pinned(ds, feats, seed=3))
        st = tr._run_train(src, style, 10_000, "T")
        return tr, st

    tr_p, st_p = run(False)
    tr_s, st_s = run(True)
    # capacity caps at the 10 unique images -> 2 rows/chunk -> 13 batch
    # rows run as 6 chunks of 2 + a 1-row tail (both compiled shapes hit)
    assert np.isfinite(st_s.loss)
    np.testing.assert_allclose(st_s.loss, st_p.loss, rtol=1e-6)
    _assert_trees_close(tr_p.dec, tr_s.dec, rtol=1e-6, atol=1e-7)
    _assert_trees_close(tr_p.head, tr_s.head, rtol=1e-6, atol=1e-7)


def test_streamed_val_matches_pinned(data, tmp_path):
    """Streamed validation: loss/top-5/BLEU-4 equal the pinned whole-split
    dispatch on the same (unshuffled) split."""
    vocab, ds, feats = data
    tr = _trainer(vocab, tmp_path, tag="val")
    va_p = tr._run_val(_pinned(ds, feats, seed=0, shuffle=False), 0)
    va_s = tr._run_val(
        _streamed(ds, feats, seed=0, capacity=3 * B, shuffle=False), 0)
    np.testing.assert_allclose(va_s.loss, va_p.loss, rtol=1e-6)
    np.testing.assert_allclose(va_s.top5, va_p.top5, rtol=1e-6)
    np.testing.assert_allclose(va_s.bleu4, va_p.bleu4, rtol=1e-9)


def test_streamed_attention_family(data, tmp_path):
    """The motivating case — spatial attention features too big to pin:
    streamed emotion-track epoch matches the pinned one."""
    vocab, ds, _ = data
    cfg = AttentionDecoderConfig(
        vocab_size=len(vocab), embed_size=16, hidden_size=24,
        factored_size=24, attention_size=16, feature_size=FEAT, dropout=0.0,
        max_seq_length=10)
    rng = np.random.default_rng(1)
    sp = {e.image: rng.standard_normal((5, FEAT)).astype(np.float32)
          for e in ds}
    provider = lambda n: sp[n]  # noqa: E731

    def run(streamed):
        tr = _trainer(vocab, tmp_path, family="factored_att", cfg=cfg,
                      tag=f"att{streamed}")
        src = (_streamed(ds, None, seed=5, capacity=4 * B,
                         feature_of=provider) if streamed
               else _pinned(ds, None, seed=5, feature_of=provider))
        st = tr._run_train(src, 1, 10_000, "HAP")
        return tr, st

    tr_p, st_p = run(False)
    tr_s, st_s = run(True)
    np.testing.assert_allclose(st_s.loss, st_p.loss, rtol=1e-6)
    _assert_trees_close(tr_p.dec, tr_s.dec, rtol=1e-6, atol=1e-7)


def test_streamed_on_mesh_matches_single(data, tmp_path):
    """Streamed chunks compose with the DP mesh: per-chunk buffers replicate
    and gathered batches reshard over the data axis."""
    vocab, ds, feats = data

    def run(mesh):
        tr = _trainer(vocab, tmp_path, mesh=mesh,
                      tag=f"mesh{mesh is not None}")
        sd = device_data.from_examples_streamed(
            ds, batch_size=8, max_len=MAXLEN,
            image_provider=lambda n: feats[n], shuffle=True, seed=2,
            mesh=mesh, budget_bytes=3 * 16 * FEAT * 4)
        st = tr._run_train(sd, 0, 10_000, "FAC")
        return tr, st

    tr_s, st_s = run(None)
    tr_m, st_m = run(make_mesh((8, 1)))
    np.testing.assert_allclose(st_m.loss, st_s.loss, rtol=2e-3)
    _assert_trees_close(tr_s.dec, tr_m.dec, rtol=2e-3, atol=5e-4)


def test_streamed_full_factual_training(data, tmp_path):
    """train_factual_only drives streamed train epochs AND streamed val
    end-to-end (chunked scans + BLEU + best-checkpointing)."""
    vocab, ds, feats = data
    tr = _trainer(vocab, tmp_path, tag="full")
    train = _streamed(ds, feats, seed=0, capacity=4 * B)
    val = _streamed(ds, feats, seed=0, capacity=4 * B, shuffle=False)
    out = tr.train_factual_only(train, val, num_epochs=2)
    assert np.isfinite(out["best_bleu4"]["factual"])


def test_streamed_progress_checkpoints(data, tmp_path):
    """Mid-epoch preemption safety holds for streamed epochs: a progress
    record is written at every chunk boundary, and a fresh trainer resumed
    from a mid-epoch record finishes with the same parameters as the
    uninterrupted run."""
    vocab, ds, feats = data

    # uninterrupted run: a record lands at every streamed-chunk boundary
    tr_full = _trainer(vocab, tmp_path, tag="progF", progress_chunk=1)
    sd_f = _streamed(ds, feats, seed=7, capacity=5 * B)
    rows = []
    tr_full._progress_hook = lambda e, p, r: rows.append(r)
    tr_full._run_train(sd_f, 0, 10_000, "T", epoch=0)
    # 13 batch rows at 2 rows/chunk (capacity caps at 10 unique images)
    assert rows == [2, 4, 6, 8, 10, 12, 13]

    # "preempted" run: killed right after the first chunk's record
    tr_a = _trainer(vocab, tmp_path, tag="progA", progress_chunk=1)
    sd_a = _streamed(ds, feats, seed=7, capacity=5 * B)

    def killer(e, p, r):
        if r == 4:
            raise KeyboardInterrupt  # simulated preemption

    tr_a._progress_hook = killer
    with pytest.raises(KeyboardInterrupt):
        tr_a._run_train(sd_a, 0, 10_000, "T", epoch=0)

    # fresh trainer in the same model_dir restores the record and finishes
    # the epoch — parameters must BIT-match the uninterrupted run
    tr_b = _trainer(vocab, tmp_path, tag="progA", progress_chunk=1)
    sd_b = _streamed(ds, feats, seed=7, capacity=5 * B)
    rec = tr_b._resume_progress({0: sd_b})
    assert rec is not None and rec["row"] == 4
    tr_b._run_train(sd_b, 0, 10_000, "T", epoch=0,
                    start_row=rec["row"],
                    loss_prefix=(rec["losses"], rec["ntoks"]))
    _assert_trees_close(tr_full.dec, tr_b.dec, rtol=0, atol=0)
    _assert_trees_close(tr_full.head, tr_b.head, rtol=0, atol=0)


def test_streamed_builder_capacity(data):
    """from_examples_streamed sizes the buffer to a THIRD of the budget
    (double buffering + the epoch scan's loop-state copy of the active
    buffer) and never above the unique-image count."""
    _, ds, feats = data
    per = FEAT * 4
    sd = device_data.from_examples_streamed(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], budget_bytes=18 * per)
    assert sd.capacity == max(6, B)
    sd = device_data.from_examples_streamed(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], budget_bytes=10_000 * per)
    assert sd.capacity == 10  # capped at the unique-image count
    assert sd.host_features.shape == (10, FEAT)
    assert isinstance(sd, device_data.DeviceCaptionData)  # routing subclass
