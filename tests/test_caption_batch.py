"""Batch captioning CLI (`cli/caption_batch.py`): an overfit model must
caption every image in the batch with its training caption through the
shared fast-path chain, and the detok must follow the serving contract
(strip specials, drop trailing ``<unk>`` — ``app/backend/sample.py:82-96``)."""

import numpy as np
import jax
import jax.numpy as jnp

from icee_tpu.cli.caption_batch import caption_batch
from icee_tpu.core.config import DecoderConfig, EncoderConfig, TrainConfig
from icee_tpu.data import build_vocab, load_caption_dataset
from icee_tpu.data.pipeline import caption_dataset_loader
from icee_tpu.models import encoder as enc_mod
from icee_tpu.models import factored_lstm as fl
from icee_tpu.train.loops import MultitaskTrainer

CORPUS = (
    "i1.jpg#0\tseorang anak bermain bola\n"
    "i2.jpg#0\tseekor anjing coklat berlari\n"
    "i3.jpg#0\tdua orang tua duduk\n"
)

FEAT = 16


def test_caption_batch_reproduces_overfit_captions(tmp_path):
    (tmp_path / "train.txt").write_text(CORPUS)
    vocab = build_vocab(str(tmp_path / "train.txt"), threshold=1)
    ds = load_caption_dataset(str(tmp_path / "train.txt"), vocab)

    rng = np.random.default_rng(0)
    feats = {e.image: rng.standard_normal((FEAT,)).astype(np.float32)
             for e in ds}

    def loader():
        return caption_dataset_loader(
            ds, batch_size=3, max_len=10,
            image_provider=lambda n: feats[n], shuffle=True, seed=0,
            prefetch=0)

    cfg = DecoderConfig(vocab_size=len(vocab), embed_size=24, hidden_size=32,
                        factored_size=32, dropout=0.0, max_seq_length=8)
    tcfg = TrainConfig(mode="happy", lr_caption=5e-3,
                       teacher_forcing_ratio=0.8, log_step=10_000)
    trainer = MultitaskTrainer(
        cfg, tcfg, vocab,
        fl.init_params(jax.random.PRNGKey(0), cfg),
        enc_mod.init_head_params(jax.random.PRNGKey(1),
                                 EncoderConfig(embed_size=24,
                                               feature_size=FEAT)),
        model_dir=str(tmp_path / "m"), data_name="cb")

    last = None
    for _ in range(300):
        last = trainer._run_train(loader(), 0, 10_000, "FAC")
    assert last.loss < 0.05, f"train loss stuck at {last.loss}"

    # batch_size=2 over 3 images also exercises the final-chunk padding
    names = [e.image for e in ds]
    out = caption_batch(
        trainer.dec, trainer.head, cfg, vocab, names,
        lambda n: feats[n], mode_idx=0, batch_size=2, k=5,
        feed_feature=True)

    assert sorted(out) == sorted(names)
    for e in ds:
        want = " ".join(vocab.idx2word[i] for i in e.caption_ids[1:-1])
        assert out[e.image] == want, f"{e.image}: {out[e.image]!r} != {want!r}"


def test_caption_batch_data_parallel_matches_single(tmp_path):
    """--data_parallel path: the beam under shard_map over the 8-device
    virtual mesh must produce the same captions as the single-device
    decode."""
    from icee_tpu.parallel.mesh import make_mesh

    (tmp_path / "train.txt").write_text(CORPUS)
    vocab = build_vocab(str(tmp_path / "train.txt"), threshold=1)
    ds = load_caption_dataset(str(tmp_path / "train.txt"), vocab)
    rng = np.random.default_rng(1)
    feats = {e.image: rng.standard_normal((FEAT,)).astype(np.float32)
             for e in ds}

    cfg = DecoderConfig(vocab_size=len(vocab), embed_size=24, hidden_size=32,
                        factored_size=32, dropout=0.0, max_seq_length=8)
    dec = fl.init_params(jax.random.PRNGKey(2), cfg)
    head = enc_mod.init_head_params(
        jax.random.PRNGKey(3), EncoderConfig(embed_size=24,
                                             feature_size=FEAT))
    names = [e.image for e in ds]

    single = caption_batch(dec, head, cfg, vocab, names,
                           lambda n: feats[n], mode_idx=1, batch_size=8,
                           k=3, feed_feature=True)
    sharded = caption_batch(dec, head, cfg, vocab, names,
                            lambda n: feats[n], mode_idx=1, batch_size=8,
                            k=3, feed_feature=True, mesh=make_mesh())
    assert single == sharded


def test_evaluate_data_parallel_matches_single(tmp_path, capsys):
    """cli/evaluate.evaluate with a mesh (the beam under shard_map) must
    report the same BLEU as the single-device decode."""
    from icee_tpu.cli.evaluate import evaluate
    from icee_tpu.parallel.mesh import make_mesh

    (tmp_path / "train.txt").write_text(CORPUS)
    vocab = build_vocab(str(tmp_path / "train.txt"), threshold=1)
    ds = load_caption_dataset(str(tmp_path / "train.txt"), vocab)
    rng = np.random.default_rng(2)
    feats = {e.image: rng.standard_normal((FEAT,)).astype(np.float32)
             for e in ds}

    cfg = DecoderConfig(vocab_size=len(vocab), embed_size=24, hidden_size=32,
                        factored_size=32, dropout=0.0, max_seq_length=8)
    dec = fl.init_params(jax.random.PRNGKey(4), cfg)
    head = enc_mod.init_head_params(
        jax.random.PRNGKey(5), EncoderConfig(embed_size=24,
                                             feature_size=FEAT))

    kw = dict(batch_size=8, k=3, print_pairs=False, feed_feature=True)
    single = evaluate(dec, head, cfg, vocab, ds, lambda n: feats[n], 0, **kw)
    sharded = evaluate(dec, head, cfg, vocab, ds, lambda n: feats[n], 0,
                       mesh=make_mesh(), **kw)
    assert single == sharded


def test_evaluate_data_parallel_attention_matches_single(tmp_path):
    """ATTENTION-family --data_parallel: evaluate with a mesh must report
    the same BLEU as the single-device attention decode (stylenet_att, the
    reference's best model family — evaluator.py:59-120)."""
    from icee_tpu.cli.evaluate import evaluate
    from icee_tpu.core.config import AttentionDecoderConfig
    from icee_tpu.models import attention as att_mod
    from icee_tpu.parallel.mesh import make_mesh

    (tmp_path / "train.txt").write_text(CORPUS)
    vocab = build_vocab(str(tmp_path / "train.txt"), threshold=1)
    ds = load_caption_dataset(str(tmp_path / "train.txt"), vocab)
    rng = np.random.default_rng(3)
    p_pix = 6
    feats = {e.image: rng.standard_normal((p_pix, FEAT)).astype(np.float32)
             for e in ds}

    cfg = AttentionDecoderConfig(
        vocab_size=len(vocab), embed_size=24, hidden_size=32,
        factored_size=32, attention_size=16, feature_size=FEAT,
        max_seq_length=8)
    dec = att_mod.init_factored_att_params(jax.random.PRNGKey(6), cfg)

    kw = dict(batch_size=8, k=3, print_pairs=False, attention=True)
    single = evaluate(dec, None, cfg, vocab, ds, lambda n: feats[n], 1, **kw)
    sharded = evaluate(dec, None, cfg, vocab, ds, lambda n: feats[n], 1,
                       mesh=make_mesh(), **kw)
    assert single == sharded
