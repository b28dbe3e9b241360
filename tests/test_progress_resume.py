"""Mid-epoch preemption safety for device-resident training
(``checkpoint/progress.py`` + ``TrainConfig.progress_chunk``).

The whole-epoch device scan makes an epoch ONE dispatch; with
``progress_chunk > 0`` it runs as chunked dispatches and a progress record
lands after every chunk, so a killed run resumes INSIDE the epoch.  Beyond
the reference (its host loop resumes only at epoch boundaries,
``stylenet/train_multitask.py:169-177``).  These tests kill a run at an
exact (epoch, pass, row) via the ``_progress_hook`` and require the
resumed run to finish with parameters identical to an uninterrupted run.
"""

import numpy as np
import jax
import pytest

from icee_tpu.checkpoint import progress as prog_mod
from icee_tpu.core.config import DecoderConfig, EncoderConfig, TrainConfig
from icee_tpu.data import build_vocab, load_caption_dataset
from icee_tpu.data import device as device_data
from icee_tpu.data.pipeline import caption_dataset_loader
from icee_tpu.models import encoder as enc_mod
from icee_tpu.models import factored_lstm as fl
from icee_tpu.train.loops import MultitaskTrainer, TransferTrainer

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
EMO_CORPUS = (
    "i1.jpg#0\tseorang anak bermain bola dengan gembira\n"
    "i2.jpg#0\tseekor anjing berlari dengan riang\n"
    "i3.jpg#0\tdua orang tua tertawa senang\n"
    "i4.jpg#0\tseorang wanita membaca buku sambil tersenyum\n"
    "i5.jpg#0\tseorang pria bahagia di pantai\n"
    "i6.jpg#0\tseekor kucing bermain riang\n"
)
FEAT, B, MAXLEN = 16, 4, 12


class Killed(RuntimeError):
    """Raised by the progress hook to simulate preemption."""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    p = tmp_path_factory.mktemp("progress")
    (p / "fac.txt").write_text(CORPUS)
    (p / "emo.txt").write_text(EMO_CORPUS)
    vocab = build_vocab(str(p / "fac.txt"), threshold=1)
    ds = load_caption_dataset(str(p / "fac.txt"), vocab)
    ds_emo = load_caption_dataset(str(p / "emo.txt"), vocab)
    rng = np.random.default_rng(0)
    feats = {}
    for e in list(ds) + list(ds_emo):
        feats.setdefault(
            e.image, rng.standard_normal((FEAT,)).astype(np.float32))
    return vocab, ds, ds_emo, feats


def _trainer(vocab, model_dir, progress_chunk, cls=MultitaskTrainer):
    cfg = DecoderConfig(vocab_size=len(vocab), embed_size=16, hidden_size=24,
                        factored_size=24, dropout=0.0, max_seq_length=10)
    tcfg = TrainConfig(mode="happy", lr_caption=5e-3, lr_language=5e-3,
                       teacher_forcing_ratio=1.0, log_step=10_000,
                       log_step_emotion=10_000,
                       progress_chunk=progress_chunk)
    dec = fl.init_params(jax.random.PRNGKey(0), cfg)
    head = enc_mod.init_head_params(
        jax.random.PRNGKey(1), EncoderConfig(embed_size=16,
                                             feature_size=FEAT))
    return cls(cfg, tcfg, vocab, dec, head, family="factored",
               model_dir=model_dir, data_name="prog")


def _loaders(ds, ds_emo, feats, seed=3):
    """Fresh loader set per run: device-resident train splits (stateful
    shuffle generators), unshuffled host val loaders."""
    train = device_data.from_examples(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], shuffle=True, seed=seed)
    emo = device_data.from_examples(
        ds_emo, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], shuffle=True, seed=seed + 1)
    val = caption_dataset_loader(
        ds, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], shuffle=False, seed=0, prefetch=0)
    val_emo = caption_dataset_loader(
        ds_emo, batch_size=B, max_len=MAXLEN,
        image_provider=lambda n: feats[n], shuffle=False, seed=0, prefetch=0)
    # ordered as MultitaskTrainer.train's positional args
    return train, val, emo, val_emo


def _assert_trees_equal(a, b, what):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert len(fa) == len(fb)
    for (path, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(
            np.asarray(x), np.asarray(y),
            err_msg=f"{what} mismatch at {jax.tree_util.keystr(path)}")


def test_chunked_epoch_bitmatches_whole_epoch(data, tmp_path):
    """progress_chunk splits the epoch into several dispatches of the SAME
    jitted step scan — params and the loss trace must bit-match the
    single whole-epoch dispatch."""
    vocab, ds, ds_emo, feats = data

    def run(chunk):
        tr = _trainer(vocab, str(tmp_path / f"chunk{chunk}"), chunk)
        train, _, _, _ = _loaders(ds, ds_emo, feats)  # train split only
        st = tr._run_train(train, 0, 10_000, "FAC", epoch=0, pass_idx=0)
        return tr, st

    tr_whole, st_whole = run(0)
    tr_chunk, st_chunk = run(2)
    assert st_chunk.loss == st_whole.loss
    _assert_trees_equal(tr_whole.dec, tr_chunk.dec, "dec")
    _assert_trees_equal(tr_whole.head, tr_chunk.head, "head")
    np.testing.assert_array_equal(np.asarray(tr_whole.rng),
                                  np.asarray(tr_chunk.rng))
    # the chunked run left a progress record at the final row
    rec = prog_mod.peek_progress(str(tmp_path / "chunk2"), "prog")
    assert rec is not None and int(rec["row"]) == 3  # 10 ex, B=4 -> 3 rows


@pytest.mark.parametrize("kill_at", [(1, 0, 2), (1, 1, 1), (0, 0, 1)],
                         ids=["epoch1-fac-row2", "epoch1-emo-row1",
                              "epoch0-fac-row1"])
def test_multitask_kill_resume_bitmatch(data, tmp_path, kill_at):
    """Kill the multitask loop at an exact (epoch, pass, chunk-row) and
    resume with a FRESH trainer + fresh loaders: final params, optimizer
    states and plateau counters must equal the uninterrupted run's."""
    vocab, ds, ds_emo, feats = data
    tag = "-".join(map(str, kill_at))

    # uninterrupted reference run
    ref = _trainer(vocab, str(tmp_path / f"ref{tag}"), 1)
    ref.train(*_loaders(ds, ds_emo, feats), num_epochs=2)

    # killed run
    mdir = str(tmp_path / f"kill{tag}")
    victim = _trainer(vocab, mdir, 1)

    def hook(epoch, pass_idx, row):
        if (epoch, pass_idx, row) == kill_at:
            raise Killed

    victim._progress_hook = hook
    with pytest.raises(Killed):
        victim.train(*_loaders(ds, ds_emo, feats), num_epochs=2)
    assert prog_mod.peek_progress(mdir, "prog") is not None

    # fresh-process resume: new trainer object, new loaders, same model_dir
    resumed = _trainer(vocab, mdir, 1)
    out = resumed.train(*_loaders(ds, ds_emo, feats), num_epochs=2)

    _assert_trees_equal(ref.dec, resumed.dec, "dec")
    _assert_trees_equal(ref.head, resumed.head, "head")
    np.testing.assert_array_equal(np.asarray(ref.rng),
                                  np.asarray(resumed.rng))
    assert resumed.epochs_since_improvement == ref.epochs_since_improvement
    assert resumed.best_bleu4 == ref.best_bleu4
    assert out["best_bleu4"] == ref.best_bleu4
    # record cleared once the loop ran to completion
    assert prog_mod.peek_progress(mdir, "prog") is None


def test_factual_only_kill_resume(data, tmp_path):
    """train_factual_only (the transfer stage-1 FAC_BEST producer) resumes
    mid-epoch too."""
    vocab, ds, ds_emo, feats = data

    def fac_loaders():
        train, val, _, _ = _loaders(ds, ds_emo, feats)
        return train, val

    ref = _trainer(vocab, str(tmp_path / "fref"), 1)
    ref.train_factual_only(*fac_loaders(), num_epochs=2)

    mdir = str(tmp_path / "fkill")
    victim = _trainer(vocab, mdir, 1)

    def hook(epoch, pass_idx, row):
        if (epoch, pass_idx, row) == (1, 0, 2):
            raise Killed

    victim._progress_hook = hook
    with pytest.raises(Killed):
        victim.train_factual_only(*fac_loaders(), num_epochs=2)

    resumed = _trainer(vocab, mdir, 1)
    resumed.train_factual_only(*fac_loaders(), num_epochs=2)
    _assert_trees_equal(ref.dec, resumed.dec, "dec")
    _assert_trees_equal(ref.head, resumed.head, "head")
    assert prog_mod.peek_progress(mdir, "prog") is None


def test_save_is_crash_atomic(tmp_path):
    """A kill can land DURING a save — the previous record must
    survive every instant of ``save_progress``'s write+swap sequence."""
    import os

    folder = str(tmp_path / "atomic")
    rec1 = prog_mod.make_record(
        epoch=0, pass_idx=0, row=1, rng=np.zeros(2, np.uint32),
        params={"w": np.ones(3, np.float32)},
        opt_states={"o": np.zeros(3, np.float32)},
        losses=np.zeros(4, np.float32), ntoks=np.ones(4, np.float32),
        epochs_since_improvement={"factual": 0}, best_bleu4={"factual": 0.0})
    prog_mod.save_progress(folder, "prog", rec1)
    path = prog_mod.progress_path(folder, "prog")
    # no swap remnants after a clean save
    assert os.path.isdir(path)
    assert not os.path.isdir(path + ".old")
    assert not os.path.isdir(path + ".new")

    # kill window 1: new record fully written, primary renamed to .old,
    # not yet swapped in -> the .old survivor is the readable record
    os.rename(path, path + ".old")
    got = prog_mod.peek_progress(folder, "prog")
    assert got is not None and int(got["row"]) == 1

    # a subsequent save replaces everything and heals the layout
    rec2 = dict(rec1, row=np.asarray(2))
    prog_mod.save_progress(folder, "prog", rec2)
    assert os.path.isdir(path) and not os.path.isdir(path + ".old")
    assert int(prog_mod.peek_progress(folder, "prog")["row"]) == 2

    # kill window 2: a half-written .new beside a live record -> the live
    # record wins and the next save clears the remnant
    os.makedirs(path + ".new")
    assert int(prog_mod.peek_progress(folder, "prog")["row"]) == 2
    prog_mod.save_progress(folder, "prog", rec1)
    assert int(prog_mod.peek_progress(folder, "prog")["row"]) == 1

    prog_mod.clear_progress(folder, "prog")
    assert prog_mod.peek_progress(folder, "prog") is None


def test_transfer_kill_resume(data, tmp_path):
    """TransferTrainer (masked style-only optimizer) resumes mid-epoch with
    the masked optimizer state intact."""
    vocab, ds, ds_emo, feats = data

    def emo_loaders():
        _, _, emo, val_emo = _loaders(ds, ds_emo, feats)
        return emo, val_emo

    ref = _trainer(vocab, str(tmp_path / "tref"), 1, cls=TransferTrainer)
    ref.train_transfer(*emo_loaders(), num_epochs=2)

    mdir = str(tmp_path / "tkill")
    victim = _trainer(vocab, mdir, 1, cls=TransferTrainer)

    def hook(epoch, pass_idx, row):
        if (epoch, pass_idx, row) == (1, 0, 1):
            raise Killed

    victim._progress_hook = hook
    with pytest.raises(Killed):
        victim.train_transfer(*emo_loaders(), num_epochs=2)

    resumed = _trainer(vocab, mdir, 1, cls=TransferTrainer)
    resumed.train_transfer(*emo_loaders(), num_epochs=2)
    _assert_trees_equal(ref.dec, resumed.dec, "dec")
    assert prog_mod.peek_progress(mdir, "prog") is None


def test_per_batch_kill_resume_bitmatch(data, tmp_path):
    """The pinned-per-batch tier (``pin_plan`` middle tier, round 5)
    writes the same progress records per batch row and resumes mid-epoch
    bit-identically — each batch is its own dispatch, so chunk boundaries
    cannot even change the compiled program."""
    vocab, ds, ds_emo, feats = data

    def loaders():
        train, val, emo, val_emo = _loaders(ds, ds_emo, feats)
        train.per_batch = True
        emo.per_batch = True
        return train, val, emo, val_emo

    ref = _trainer(vocab, str(tmp_path / "pbref"), 1)
    ref.train(*loaders(), num_epochs=2)

    mdir = str(tmp_path / "pbkill")
    victim = _trainer(vocab, mdir, 1)

    def hook(epoch, pass_idx, row):
        if (epoch, pass_idx, row) == (1, 0, 2):
            raise Killed

    victim._progress_hook = hook
    with pytest.raises(Killed):
        victim.train(*loaders(), num_epochs=2)
    assert prog_mod.peek_progress(mdir, "prog") is not None

    resumed = _trainer(vocab, mdir, 1)
    resumed.train(*loaders(), num_epochs=2)
    _assert_trees_equal(ref.dec, resumed.dec, "dec")
    _assert_trees_equal(ref.head, resumed.head, "head")
    np.testing.assert_array_equal(np.asarray(ref.rng),
                                  np.asarray(resumed.rng))
    assert prog_mod.peek_progress(mdir, "prog") is None
