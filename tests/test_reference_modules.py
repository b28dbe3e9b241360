"""Parity against the reference's OWN torch modules (VERDICT r3 missing #1).

``tests/test_cross_framework_parity.py`` proves icee_tpu against a
hand-transcribed torch re-implementation of the reference algorithms; a
transcription can silently share a misreading with the JAX port.  This file
closes that hole: it ``exec``s the REAL reference sources from
``/root/reference`` (read-only), instantiates the real modules, pushes their
own ``state_dict()`` through ``checkpoint/torch_import.py``, and requires

- identical forward logits (f32 tolerance) in the reference's packed order,
- identical beam captions for BOTH feature-feeding semantics
  (research ``stylenet/model.py:198-294`` never feeds the image feature;
  serving ``app/backend/model.py:414-417`` feeds it as the step-1 input),
- identical seq2seq greedy samples and training logits including the
  decoder-ignores-encoder-state quirk (``seq2seq/model.py:168-176``).

Environment patches applied at load time (each one documented here, none
changes reference semantics):

1. ``torchvision`` is not installed (zero egress) — a stub module satisfies
   ``import torchvision.models as models``; ``EncoderCNN`` is never
   instantiated by these tests (the backbone parity is covered by
   ``tests/test_resnet.py``'s torch-oracle importer tests).
2. The reference targets torch 1.1 where ``LongTensor / int`` is floor
   integer division (the beam parent-index math, e.g.
   ``stylenet/model.py:249-250``).  Under torch 2.x that ``/`` returns
   float and the subsequent tensor indexing raises, so the loader rewrites
   ``top_k_words / self.vocab_size`` to
   ``torch.div(top_k_words, self.vocab_size, rounding_mode='floor')`` —
   bit-identical to the torch-1.1 behavior for these non-negative indices.

All modules run under ``.eval()`` (dropout identity) with
``teacher_forcing_ratio=1.0`` (the reference's per-step ``random.random() <
ratio`` coin is then always True), so every compared path is deterministic.
"""

import pathlib
import sys
import types

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

REF_ROOT = pathlib.Path("/root/reference")

V, E, H, F = 96, 12, 16, 16
A_DIM, FS, P_PIX = 10, 14, 6
K, MAX_STEPS = 4, 7


@pytest.fixture(autouse=True, scope="module")
def _reference_sources():
    """These tests execute the reference's own sources; without a checkout
    of the reference there is nothing to compare against."""
    if not REF_ROOT.is_dir():
        pytest.skip(f"reference sources not found at {REF_ROOT}")


def _stub_torchvision():
    """Satisfy ``import torchvision.models as models`` (patch #1 above)."""
    if "torchvision" in sys.modules:
        return
    tv = types.ModuleType("torchvision")
    tvm = types.ModuleType("torchvision.models")

    def _unavailable(*a, **k):  # only EncoderCNN would call this
        raise RuntimeError("torchvision stub: no pretrained backbone in tests")

    tvm.resnet152 = _unavailable
    tv.models = tvm
    sys.modules["torchvision"] = tv
    sys.modules["torchvision.models"] = tvm


_REF_CACHE = {}


def load_reference_module(relpath: str):
    """Exec a reference source file with the documented compat patches."""
    if relpath in _REF_CACHE:
        return _REF_CACHE[relpath]
    _stub_torchvision()
    src = (REF_ROOT / relpath).read_text()
    patched = src.replace(
        "top_k_words / self.vocab_size",
        "torch.div(top_k_words, self.vocab_size, rounding_mode='floor')",
    )  # patch #2 above (torch-1.1 integer division)
    mod = types.ModuleType(
        "ref_" + relpath.replace("/", "_").removesuffix(".py"))
    mod.__file__ = str(REF_ROOT / relpath)
    exec(compile(patched, mod.__file__, "exec"), mod.__dict__)
    _REF_CACHE[relpath] = mod
    return mod


def _pack_like_reference(ours_btv: np.ndarray, lengths) -> np.ndarray:
    """Reorder our padded (B, T, ...) output into the reference's packed
    order: per timestep, the first ``batch_size_t`` rows concatenated
    (``pack_padded_sequence`` semantics, stylenet/model.py:173-193)."""
    rows = []
    for t in range(max(lengths)):
        b_sz = sum(1 for ln in lengths if ln > t)
        rows.append(ours_btv[:b_sz, t])
    return np.concatenate(rows, axis=0)


def _beam_tokens(res, i):
    return np.asarray(res.tokens[i][: int(res.length[i])]).tolist()


@pytest.fixture(scope="module")
def caption_batch():
    g = torch.Generator().manual_seed(11)
    lengths = [6, 5, 5, 3]
    t_max = max(lengths)
    caps = torch.randint(4, V, (len(lengths), t_max), generator=g)
    caps[:, 0] = 1  # <start>
    for b, ln in enumerate(lengths):
        caps[b, ln - 1] = 2  # <end>
        caps[b, ln:] = 0
    return caps, lengths


# --------------------------------------------------------------------------
# StyleNet FactoredLSTM (stylenet/model.py)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stylenet_ref():
    mod = load_reference_module("stylenet/model.py")
    torch.manual_seed(0)
    dec = mod.DecoderFactoredLSTM(E, H, F, V, 1, feature_size=E,
                                  max_seq_length=MAX_STEPS)
    dec.eval()
    return dec


@pytest.mark.parametrize("mode,style_idx",
                         [("factual", 0), ("happy", 1), ("angry", 3)])
def test_stylenet_forward_logits(stylenet_ref, caption_batch, mode, style_idx):
    from icee_tpu.checkpoint.torch_import import (
        import_factored_decoder_state_dict,
    )
    from icee_tpu.core.config import DecoderConfig
    from icee_tpu.models import factored_lstm as fl

    dec = stylenet_ref
    caps, lengths = caption_batch
    feats = torch.randn(caps.shape[0], E,
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = dec.forward(caps, lengths, features=feats,
                           teacher_forcing_ratio=1.0, mode=mode).numpy()

    params = import_factored_decoder_state_dict(dec.state_dict())
    cfg = DecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                        factored_size=F, dropout=0.0)
    got = np.asarray(fl.forward(
        params, cfg, jnp.asarray(caps.numpy()), jnp.asarray(feats.numpy()),
        style_idx, teacher_forcing_ratio=1.0, train=False))
    np.testing.assert_allclose(_pack_like_reference(got, lengths), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode,style_idx", [("factual", 0), ("sad", 2)])
def test_stylenet_research_beam(stylenet_ref, mode, style_idx):
    """stylenet/model.py:198-294: the features arg is shrunk with the beam
    but NEVER fed to the LSTM (the research-semantics quirk) — step-1 input
    is the embedded <start>.  icee side: feed_feature=False."""
    from icee_tpu.checkpoint.torch_import import (
        import_factored_decoder_state_dict,
    )
    from icee_tpu.decode.fast import beam_fn

    dec = stylenet_ref
    params = import_factored_decoder_state_dict(dec.state_dict())
    batch = 3
    feats = torch.randn(batch, E, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = [dec.sample(feats[i:i + 1], 1, 2, k=K, mode=mode)[0].tolist()
                for i in range(batch)]

    res = beam_fn("stylenet", params, batch, K, MAX_STEPS, V, 1, 2,
                  feed_feature=False)(jnp.asarray(feats.numpy()), style_idx)
    for i in range(batch):
        assert _beam_tokens(res, i) == want[i], f"img {i}"


def test_serving_factored_beam():
    """app/backend/model.py:414-417: the serving copy feeds the image
    feature as the step-1 input.  icee side: feed_feature=True."""
    from icee_tpu.checkpoint.torch_import import (
        import_factored_decoder_state_dict,
    )
    from icee_tpu.decode.fast import beam_fn

    mod = load_reference_module("app/backend/model.py")
    torch.manual_seed(1)
    dec = mod.DecoderFactoredLSTM(E, H, F, V, 1, feature_size=E,
                                  max_seq_length=MAX_STEPS)
    dec.eval()
    params = import_factored_decoder_state_dict(dec.state_dict())

    batch = 3
    feats = torch.randn(batch, E, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = [dec.sample(feats[i:i + 1], 1, 2, k=K,
                           mode="happy")[0].tolist() for i in range(batch)]

    res = beam_fn("stylenet", params, batch, K, MAX_STEPS, V, 1, 2)(
        jnp.asarray(feats.numpy()), 1)
    for i in range(batch):
        assert _beam_tokens(res, i) == want[i], f"img {i}"


# --------------------------------------------------------------------------
# NIC (nic/model.py + serving copy)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nic_ref():
    mod = load_reference_module("nic/model.py")
    torch.manual_seed(2)
    dec = mod.DecoderRNN(E, H, V, 1, feature_size=E,
                         max_seq_length=MAX_STEPS)
    dec.eval()
    return dec


def test_nic_forward_logits(nic_ref, caption_batch):
    from icee_tpu.checkpoint.torch_import import import_nic_decoder_state_dict
    from icee_tpu.core.config import DecoderConfig
    from icee_tpu.models import lstm as nic

    caps, lengths = caption_batch
    feats = torch.randn(caps.shape[0], E,
                        generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = nic_ref.forward(caps, lengths, feats,
                               teacher_forcing_ratio=1.0).numpy()

    params = import_nic_decoder_state_dict(nic_ref.state_dict())
    cfg = DecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                        dropout=0.0, factored=False)
    got = np.asarray(nic.forward(
        params, cfg, jnp.asarray(caps.numpy()), jnp.asarray(feats.numpy()),
        teacher_forcing_ratio=1.0, train=False))
    np.testing.assert_allclose(_pack_like_reference(got, lengths), want,
                               rtol=2e-5, atol=2e-5)


def test_nic_research_beam(nic_ref):
    """nic/model.py:117-162 shares the research quirk: features never fed
    (step-1 input is the embedded <start>)."""
    from icee_tpu.checkpoint.torch_import import import_nic_decoder_state_dict
    from icee_tpu.decode.fast import beam_fn

    params = import_nic_decoder_state_dict(nic_ref.state_dict())
    batch = 3
    feats = torch.randn(batch, E, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = [nic_ref.sample(feats[i:i + 1], 1, 2, k=K)[0].tolist()
                for i in range(batch)]
    res = beam_fn("nic", params, batch, K, MAX_STEPS, V, 1, 2,
                  feed_feature=False)(jnp.asarray(feats.numpy()), 0)
    for i in range(batch):
        assert _beam_tokens(res, i) == want[i], f"img {i}"


def test_serving_nic_beam():
    """app/backend/model.py:141-143: serving NIC beam feeds the feature at
    step 1 (and does NOT shrink the features array — it is constant)."""
    from icee_tpu.checkpoint.torch_import import import_nic_decoder_state_dict
    from icee_tpu.decode.fast import beam_fn

    mod = load_reference_module("app/backend/model.py")
    torch.manual_seed(3)
    dec = mod.DecoderRNN(E, H, V, 1, feature_size=E,
                         max_seq_length=MAX_STEPS)
    dec.eval()
    params = import_nic_decoder_state_dict(dec.state_dict())

    batch = 3
    feats = torch.randn(batch, E, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        want = [dec.sample(feats[i:i + 1], 1, 2, mode="factual",
                           k=K)[0].tolist() for i in range(batch)]

    res = beam_fn("nic", params, batch, K, MAX_STEPS, V, 1, 2)(
        jnp.asarray(feats.numpy()), 0)
    for i in range(batch):
        assert _beam_tokens(res, i) == want[i], f"img {i}"


# --------------------------------------------------------------------------
# StyleNet + Attention (stylenet/model_att.py)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stylenet_att_ref():
    mod = load_reference_module("stylenet/model_att.py")
    torch.manual_seed(4)
    dec = mod.DecoderFactoredLSTMAtt(A_DIM, E, H, F, V, 1, feature_size=FS,
                                     max_seq_length=MAX_STEPS)
    dec.eval()
    return dec


@pytest.mark.parametrize("mode,style_idx", [("factual", 0), ("happy", 1)])
def test_stylenet_att_forward(stylenet_att_ref, caption_batch, mode,
                              style_idx):
    from icee_tpu.checkpoint.torch_import import (
        import_factored_att_decoder_state_dict,
    )
    from icee_tpu.core.config import AttentionDecoderConfig
    from icee_tpu.models.attention import factored_att_forward

    dec = stylenet_att_ref
    caps, lengths = caption_batch
    feats = torch.randn(caps.shape[0], P_PIX, FS,
                        generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        want, want_alphas = dec.forward(caps, lengths, feats,
                                        teacher_forcing_ratio=1.0, mode=mode)

    params = import_factored_att_decoder_state_dict(dec.state_dict())
    cfg = AttentionDecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                                 factored_size=F, feature_size=FS,
                                 attention_size=A_DIM, dropout=0.0)
    got, got_alphas = factored_att_forward(
        params, cfg, jnp.asarray(caps.numpy()), jnp.asarray(feats.numpy()),
        style_idx, teacher_forcing_ratio=1.0, train=False)
    np.testing.assert_allclose(
        _pack_like_reference(np.asarray(got), lengths), want.numpy(),
        rtol=2e-5, atol=2e-5)
    # reference alphas are written only for the live rows [:b_sz, t]
    got_alphas = np.asarray(got_alphas)
    for t in range(max(lengths)):
        b_sz = sum(1 for ln in lengths if ln > t)
        np.testing.assert_allclose(got_alphas[:b_sz, t],
                                   want_alphas.numpy()[:b_sz, t],
                                   rtol=2e-5, atol=2e-5)


def test_stylenet_att_beam(stylenet_att_ref):
    from icee_tpu.checkpoint.torch_import import (
        import_factored_att_decoder_state_dict,
    )
    from icee_tpu.decode.fast import beam_fn

    dec = stylenet_att_ref
    params = import_factored_att_decoder_state_dict(dec.state_dict())
    batch = 3
    feats = torch.randn(batch, P_PIX, FS,
                        generator=torch.Generator().manual_seed(10))
    with torch.no_grad():
        want = [dec.sample(feats[i:i + 1], 1, 2, k=K,
                           mode="sad")[0].tolist() for i in range(batch)]

    res = beam_fn("stylenet_att", params, batch, K, MAX_STEPS, V, 1, 2)(
        jnp.asarray(feats.numpy()), 2)
    for i in range(batch):
        assert _beam_tokens(res, i) == want[i], f"img {i}"


# --------------------------------------------------------------------------
# NIC + Attention (nic/model_att.py)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nic_att_ref():
    mod = load_reference_module("nic/model_att.py")
    torch.manual_seed(5)
    dec = mod.DecoderRNNAtt(A_DIM, E, H, V, 1, feature_size=FS,
                            max_seq_length=MAX_STEPS)
    dec.eval()
    return dec


def test_nic_att_forward(nic_att_ref, caption_batch):
    from icee_tpu.checkpoint.torch_import import (
        import_nic_att_decoder_state_dict,
    )
    from icee_tpu.core.config import AttentionDecoderConfig
    from icee_tpu.models.attention import rnn_att_forward

    caps, lengths = caption_batch
    feats = torch.randn(caps.shape[0], P_PIX, FS,
                        generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        want = nic_att_ref.forward(caps, lengths, feats,
                                   teacher_forcing_ratio=1.0)
    if isinstance(want, tuple):
        want = want[0]

    params = import_nic_att_decoder_state_dict(nic_att_ref.state_dict())
    cfg = AttentionDecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                                 feature_size=FS, attention_size=A_DIM,
                                 dropout=0.0, factored=False)
    got, _ = rnn_att_forward(
        params, cfg, jnp.asarray(caps.numpy()), jnp.asarray(feats.numpy()),
        teacher_forcing_ratio=1.0, train=False)
    np.testing.assert_allclose(
        _pack_like_reference(np.asarray(got), lengths), want.numpy(),
        rtol=2e-5, atol=2e-5)


def test_nic_att_beam(nic_att_ref):
    from icee_tpu.checkpoint.torch_import import (
        import_nic_att_decoder_state_dict,
    )
    from icee_tpu.decode.fast import beam_fn

    params = import_nic_att_decoder_state_dict(nic_att_ref.state_dict())
    batch = 3
    feats = torch.randn(batch, P_PIX, FS,
                        generator=torch.Generator().manual_seed(13))
    with torch.no_grad():
        want = [nic_att_ref.sample(feats[i:i + 1], 1, 2, k=K)[0].tolist()
                for i in range(batch)]

    res = beam_fn("nic_att", params, batch, K, MAX_STEPS, V, 1, 2)(
        jnp.asarray(feats.numpy()), 0)
    for i in range(batch):
        assert _beam_tokens(res, i) == want[i], f"img {i}"


# --------------------------------------------------------------------------
# Seq2Seq (seq2seq/model.py)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seq2seq_ref():
    mod = load_reference_module("seq2seq/model.py")
    torch.manual_seed(6)
    m = mod.Seq2Seq(E, H, V, 2, max_seq_length=MAX_STEPS)
    m.eval()
    return m


def _import_s2s(m):
    from icee_tpu.checkpoint.torch_import import import_seq2seq_state_dict

    return import_seq2seq_state_dict(m.state_dict())


def test_seq2seq_factual_forward(seq2seq_ref, caption_batch):
    from icee_tpu.core.config import Seq2SeqConfig
    from icee_tpu.models import seq2seq as s2s

    caps, lengths = caption_batch
    feats = torch.randn(caps.shape[0], E,
                        generator=torch.Generator().manual_seed(14))
    with torch.no_grad():
        want = seq2seq_ref(feats, (caps, lengths),
                           teacher_forcing_ratio=1.0, mode="factual").numpy()

    params = _import_s2s(seq2seq_ref)
    cfg = Seq2SeqConfig(vocab_size=V, embed_size=E, hidden_size=H,
                        num_layers=2, dropout=0.0)
    got = np.asarray(s2s.forward(
        params, cfg, jnp.asarray(feats.numpy()),
        (jnp.asarray(caps.numpy()), jnp.asarray(lengths)), None, None,
        teacher_forcing_ratio=1.0, train=False))
    np.testing.assert_allclose(_pack_like_reference(got, lengths), want,
                               rtol=2e-5, atol=2e-5)


def test_seq2seq_emotion_forward_ignores_encoder_state(seq2seq_ref,
                                                       caption_batch):
    """The reference DecoderRNN.forward zeroes its h/c and never reads the
    encoder states it is handed (seq2seq/model.py:168-176).  This test runs
    the real module, so any icee divergence from that quirk fails here."""
    from icee_tpu.core.config import Seq2SeqConfig
    from icee_tpu.models import seq2seq as s2s

    caps, lengths = caption_batch
    dst_in = caps[:, :-1]
    dst_lengths = [ln - 1 for ln in lengths]
    feats = torch.randn(caps.shape[0], E,
                        generator=torch.Generator().manual_seed(15))
    with torch.no_grad():
        want = seq2seq_ref(feats, (caps, lengths), (dst_in, dst_lengths),
                           teacher_forcing_ratio=1.0, mode="happy").numpy()

    params = _import_s2s(seq2seq_ref)
    cfg = Seq2SeqConfig(vocab_size=V, embed_size=E, hidden_size=H,
                        num_layers=2, dropout=0.0)
    got = np.asarray(s2s.forward(
        params, cfg, jnp.asarray(feats.numpy()),
        (jnp.asarray(caps.numpy()), jnp.asarray(lengths)),
        (jnp.asarray(dst_in.numpy()), jnp.asarray(dst_lengths)),
        0,  # happy
        teacher_forcing_ratio=1.0, train=False))
    np.testing.assert_allclose(_pack_like_reference(got, dst_lengths), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode,emotion", [("factual", None), ("sad", 1)])
def test_seq2seq_greedy_sample(seq2seq_ref, mode, emotion):
    """Seq2Seq.sample: greedy encoder rollout from the feature; emotion
    decoders continue from the rollout's final state
    (seq2seq/model.py:285-301 — the states ARE used at sample time).

    Note ``Seq2Seq.__init__`` does NOT forward its ``max_seq_length`` to the
    sub-modules (seq2seq/model.py:229-254), so the real rollouts run the
    sub-module default 40 steps regardless of the ctor arg."""
    from icee_tpu.core.config import Seq2SeqConfig
    from icee_tpu.models.seq2seq import greedy_sample

    feats = torch.randn(1, E, generator=torch.Generator().manual_seed(16))
    with torch.no_grad():
        want = seq2seq_ref.sample(feats, 1, mode=mode)
    params = _import_s2s(seq2seq_ref)
    cfg = Seq2SeqConfig(vocab_size=V, embed_size=E, hidden_size=H,
                        num_layers=2, dropout=0.0, max_seq_length=40)
    got = greedy_sample(params, cfg, jnp.asarray(feats.numpy()), 1,
                        emotion=emotion)
    assert np.asarray(got)[0].tolist() == want[0].tolist()
