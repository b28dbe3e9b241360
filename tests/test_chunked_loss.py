"""Chunked-CE-from-hiddens (ops/chunked_loss.py) equivalence tests.

The chunked loss must match ``masked_cross_entropy(hiddens @ W + b, ...)``
in value AND gradients (the reference loss is CrossEntropyLoss over the
packed stream, ``stylenet/train_multitask.py:300``), and a train step built
on it must match the materialized-loss step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from icee_tpu.core.config import DecoderConfig, EncoderConfig, TrainConfig
from icee_tpu.evaluation.metrics import masked_cross_entropy
from icee_tpu.models import encoder as enc_mod
from icee_tpu.models import factored_lstm as fl
from icee_tpu.models import lstm as nic
from icee_tpu.ops.chunked_loss import auto_t_chunk, masked_ce_from_hiddens
from icee_tpu.train.steps import make_caption_steps


def _case(rng, b=6, t=11, h=16, v=37):
    hiddens = jnp.asarray(rng.standard_normal((b, t, h)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((h, v)) * 0.3, jnp.float32)
    bias = jnp.asarray(rng.standard_normal((v,)) * 0.1, jnp.float32)
    targets = jnp.asarray(rng.integers(0, v, (b, t)), jnp.int32)
    lengths = jnp.asarray(rng.integers(1, t + 1, (b,)), jnp.int32)
    sample_mask = jnp.asarray(rng.random(b) > 0.2)
    return hiddens, w, bias, targets, lengths, sample_mask


@pytest.mark.parametrize("t_chunk", [1, 3, 4, 11, 16])
def test_value_matches_materialized(rng, t_chunk):
    hiddens, w, b, tgts, lens, smask = _case(rng)
    base = masked_cross_entropy(hiddens @ w + b, tgts, lens, smask)
    got = masked_ce_from_hiddens(hiddens, w, b, tgts, lens, smask,
                                 t_chunk=t_chunk)
    np.testing.assert_allclose(np.asarray(got), np.asarray(base),
                               rtol=1e-6, atol=1e-6)


def test_grads_match_materialized(rng):
    hiddens, w, b, tgts, lens, smask = _case(rng)

    def base_loss(args):
        x, ww, bb = args
        return masked_cross_entropy(x @ ww + bb, tgts, lens, smask)

    def chunked_loss(args):
        x, ww, bb = args
        return masked_ce_from_hiddens(x, ww, bb, tgts, lens, smask, t_chunk=3)

    g_base = jax.grad(base_loss)((hiddens, w, b))
    g_ck = jax.grad(chunked_loss)((hiddens, w, b))
    for gb, gc in zip(g_base, g_ck):
        np.testing.assert_allclose(np.asarray(gc), np.asarray(gb),
                                   rtol=2e-5, atol=2e-6)


def test_no_sample_mask_and_auto_chunk(rng):
    hiddens, w, b, tgts, lens, _ = _case(rng)
    base = masked_cross_entropy(hiddens @ w + b, tgts, lens, None)
    got = masked_ce_from_hiddens(hiddens, w, b, tgts, lens, None)
    np.testing.assert_allclose(np.asarray(got), np.asarray(base),
                               rtol=1e-6, atol=1e-6)
    assert auto_t_chunk(512, 25) == 4
    assert auto_t_chunk(64, 25) == 25
    assert auto_t_chunk(4096, 25) == 1


def _fwd_case(rng, factored, v=29, e=12, h=16, f=16, b=5, t=9):
    cfg = DecoderConfig(vocab_size=v, embed_size=e, hidden_size=h,
                        factored_size=f, dropout=0.0)
    key = jax.random.PRNGKey(3)
    params = (fl.init_params(key, cfg) if factored
              else nic.init_params(key, cfg))
    feats = jnp.asarray(rng.standard_normal((b, e)), jnp.float32)
    caps = jnp.asarray(rng.integers(0, v, (b, t)), jnp.int32)
    return cfg, params, feats, caps


@pytest.mark.parametrize("factored", [True, False])
@pytest.mark.parametrize("ratio", [1.0, 0.6])
def test_forward_hiddens_consistent_with_forward(rng, factored, ratio):
    """head(forward_hiddens) == forward logits for both sampling regimes."""
    cfg, params, feats, caps = _fwd_case(rng, factored)
    key = jax.random.PRNGKey(11)
    if factored:
        logits = fl.forward(params, cfg, caps, feats, style=1,
                            teacher_forcing_ratio=ratio, rng=key, train=True)
        hid = fl.forward_hiddens(params, cfg, caps, feats, style=1,
                                 teacher_forcing_ratio=ratio, rng=key,
                                 train=True)
        recon = hid @ params["C_w"] + params["C_b"]
    else:
        logits = nic.forward(params, cfg, caps, feats,
                             teacher_forcing_ratio=ratio, rng=key, train=True)
        hid = nic.forward_hiddens(params, cfg, caps, feats,
                                  teacher_forcing_ratio=ratio, rng=key,
                                  train=True)
        recon = hid @ params["linear_w"] + params["linear_b"]
    np.testing.assert_allclose(np.asarray(recon), np.asarray(logits),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factored", [True, False])
@pytest.mark.parametrize("ratio", [1.0, 0.7])
def test_train_step_chunked_matches_materialized(rng, factored, ratio):
    """One factual + one emotion step with chunked_ce on vs off: same loss,
    (numerically) same updated params."""
    cfg, params, _, caps = _fwd_case(rng, factored, b=6, t=8)
    pooled = jnp.asarray(rng.standard_normal((6, 2048)), jnp.float32)
    lens = jnp.asarray(rng.integers(2, 9, (6,)), jnp.int32)
    smask = jnp.asarray([True, True, True, True, False, True])
    head = enc_mod.init_head_params(jax.random.PRNGKey(5),
                                    EncoderConfig(embed_size=cfg.embed_size))
    opt = optax.adam(1e-3)
    key = jax.random.PRNGKey(7)

    outs = {}
    for chunked in (False, True):
        tcfg = TrainConfig(teacher_forcing_ratio=ratio, chunked_ce=chunked)
        fac, emo, _ = make_caption_steps(cfg, tcfg, opt, opt,
                                         factored=factored)
        opt_state = opt.init((params, head))
        d1, h1, _, loss1 = fac(params, head, opt_state, pooled, caps, lens,
                               smask, key)
        opt_state2 = opt.init(params)
        d2, _, _, loss2 = emo(params, head, opt.init(params), pooled, caps,
                              lens, smask, jnp.asarray(2), key)
        del opt_state2
        outs[chunked] = (d1, h1, loss1, d2, loss2)

    base, ck = outs[False], outs[True]
    np.testing.assert_allclose(float(ck[2]), float(base[2]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ck[4]), float(base[4]),
                               rtol=1e-6, atol=1e-6)
    # Adam normalizes by sqrt(v)+eps, so fp-accumulation-order noise in
    # near-zero grads is amplified to a few % of one lr=1e-3 step; the
    # strict equivalence lives in test_grads_match_materialized.  A
    # structural bug (wrong mask/targets) shifts many entries by a full
    # step ~1e-3, far beyond this tolerance.
    for i in (0, 1, 3):  # updated dec (factual), head, dec (emotion)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=0, atol=2e-4),
            ck[i], base[i])


@pytest.mark.parametrize("factored", [True, False])
@pytest.mark.parametrize("ratio", [1.0, 0.7])
def test_attention_step_chunked_matches_materialized(rng, factored, ratio):
    from icee_tpu.core.config import AttentionDecoderConfig
    from icee_tpu.models import attention as att_mod
    from icee_tpu.train.steps import make_attention_steps

    cfg = AttentionDecoderConfig(vocab_size=31, embed_size=10, hidden_size=14,
                                 factored_size=14, feature_size=12,
                                 attention_size=9, dropout=0.0)
    key = jax.random.PRNGKey(2)
    dec = (att_mod.init_factored_att_params(key, cfg) if factored
           else att_mod.init_rnn_att_params(key, cfg))
    b, t, p = 5, 8, 6
    feats = jnp.asarray(rng.standard_normal((b, p, cfg.feature_size)),
                        jnp.float32)
    caps = jnp.asarray(rng.integers(0, 31, (b, t)), jnp.int32)
    lens = jnp.asarray(rng.integers(2, t + 1, (b,)), jnp.int32)
    smask = jnp.asarray([True, True, False, True, True])
    opt = optax.adam(1e-3)
    stepk = jax.random.PRNGKey(9)

    outs = {}
    for chunked in (False, True):
        tcfg = TrainConfig(teacher_forcing_ratio=ratio, alpha_c=1.0,
                           chunked_ce=chunked)
        fac, emo, _ = make_attention_steps(cfg, tcfg, opt, opt,
                                           factored=factored)
        d1, _, loss1 = fac(dec, opt.init(dec), feats, caps, lens, smask,
                           stepk)
        d2, _, loss2 = emo(dec, opt.init(dec), feats, caps, lens, smask,
                           jnp.asarray(1 if factored else 0), stepk)
        outs[chunked] = (d1, loss1, d2, loss2)

    base, ck = outs[False], outs[True]
    np.testing.assert_allclose(float(ck[1]), float(base[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ck[3]), float(base[3]),
                               rtol=1e-6, atol=1e-6)
    for i in (0, 2):  # see the Adam-noise note above
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=0, atol=2e-4),
            ck[i], base[i])


@pytest.mark.parametrize("ratio", [1.0, 0.7])
def test_seq2seq_step_chunked_matches_materialized(rng, ratio):
    from icee_tpu.core.config import Seq2SeqConfig
    from icee_tpu.models import seq2seq as s2s
    from icee_tpu.train.steps import make_seq2seq_steps

    scfg = Seq2SeqConfig(vocab_size=33, embed_size=12, hidden_size=16,
                         num_layers=2, dropout=0.0)
    params = s2s.init_params(jax.random.PRNGKey(0), scfg)
    head = enc_mod.init_head_params(jax.random.PRNGKey(1),
                                    EncoderConfig(embed_size=12))
    b, t = 5, 8
    pooled = jnp.asarray(rng.standard_normal((b, 2048)), jnp.float32)
    caps = jnp.asarray(rng.integers(0, 33, (b, t)), jnp.int32)
    lens = jnp.asarray(rng.integers(2, t + 1, (b,)), jnp.int32)
    smask = jnp.asarray([True, False, True, True, True])
    opt = optax.adam(1e-3)
    key = jax.random.PRNGKey(4)

    outs = {}
    for chunked in (False, True):
        tcfg = TrainConfig(teacher_forcing_ratio=ratio, chunked_ce=chunked)
        fac, emo, _, _ = make_seq2seq_steps(scfg, tcfg, opt, opt)
        p1, h1, _, loss1 = fac(params, head, opt.init(
            (params["encoder"], head)), pooled, caps, lens, smask, key)
        p2, _, loss2 = emo(params, head, opt.init(params["decoders"]),
                           pooled, caps, lens, caps, lens, smask,
                           jnp.asarray(1), key)
        outs[chunked] = (p1, h1, loss1, p2, loss2)

    base, ck = outs[False], outs[True]
    np.testing.assert_allclose(float(ck[2]), float(base[2]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ck[4]), float(base[4]),
                               rtol=1e-6, atol=1e-6)
    for i in (0, 1, 3):  # see the Adam-noise note above
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=0, atol=2e-4),
            ck[i], base[i])


@pytest.mark.parametrize("semi", [1.0, 0.6])
def test_senticap_base_step_chunked_matches_materialized(rng, semi):
    """SentiCap base step (masked-SUM loss with the 1e-37 prob floor) with
    CHUNKED_CE on vs off: same loss, numerically same updated params."""
    from icee_tpu.senticap import io as sio
    from icee_tpu.senticap import model as base_model
    from icee_tpu.senticap import train as T
    from icee_tpu.senticap.config import senticap_conf
    from icee_tpu.senticap.solver import make_solver

    records = []
    for i in range(8):
        records.append({"image": f"img{i % 4}",
                        "tokens": ["a", "dog", "runs", "fast"][: 2 + i % 3],
                        "sentiment": 1.0, "switch": [0, 1, 0, 0]})
    caps = [r["tokens"] for r in records]
    w2i, i2w = sio.build_vocab(caps, min_freq=1)
    feats = {f"img{j}": rng.standard_normal((12,)).astype(np.float32)
             for j in range(4)}
    ds = sio.make_split(records, feats, w2i, max_len=6, visual_size=12)
    data = sio.device_dataset(ds)
    idx = jnp.arange(8)
    key = jax.random.PRNGKey(3)

    outs = {}
    for chunked in (False, True):
        conf = senticap_conf(emb_size=16, lstm_hidden_size=20,
                             visual_size=12, SEMI_FORCED=semi,
                             CHUNKED_CE=chunked)
        params = base_model.init_params(jax.random.PRNGKey(0), len(w2i), conf)
        solver = make_solver(conf)
        step = T.make_base_step(conf, solver)
        p, _, loss = step(params, solver.init(params), data, idx, key)
        outs[chunked] = (p, loss)

    np.testing.assert_allclose(float(outs[True][1]), float(outs[False][1]),
                               rtol=1e-5, atol=1e-5)
    # RMSProp normalizes like Adam — see the Adam-noise note above
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=0, atol=2e-4),
        outs[True][0], outs[False][0])


def test_clamped_chunked_matches_prob_floor_loss(rng):
    """Direct check of the clamp semantics: tiny-probability targets hit the
    1e-37 floor in the materialized loss and the clamp in the chunked one,
    with zero gradient either way."""
    from icee_tpu.ops.chunked_loss import masked_sum_ce_from_hiddens
    from icee_tpu.senticap.model import PROB_FLOOR_CLAMP

    b, t, h, v = 3, 4, 8, 11
    hh = jnp.asarray(rng.standard_normal((b, t, h)), jnp.float32)
    # a head with huge spread drives some target probs below 1e-37
    w = jnp.asarray(rng.standard_normal((h, v)) * 40.0, jnp.float32)
    bias = jnp.zeros((v,), jnp.float32)
    y = jnp.asarray(rng.integers(0, v, (b, t)), jnp.int32)
    mask = jnp.asarray(rng.random((b, t)) > 0.3, jnp.float32)

    def materialized(args):
        hh_, w_ = args
        s = jax.nn.softmax(hh_ @ w_ + bias, axis=-1)
        p = jnp.take_along_axis(s, y[..., None], axis=-1)[..., 0]
        return jnp.sum(-jnp.log(jnp.maximum(p, 1e-37)) * mask)

    def chunked(args):
        hh_, w_ = args
        return masked_sum_ce_from_hiddens(hh_, w_, bias, y, mask,
                                          clamp=PROB_FLOOR_CLAMP, t_chunk=2)

    lm, gm = jax.value_and_grad(materialized)((hh, w))
    lc, gc = jax.value_and_grad(chunked)((hh, w))
    # some positions actually clamp (loss includes the floor constant)
    nll = (hh @ w + bias)
    lse = jax.nn.logsumexp(nll, axis=-1)
    tgt = jnp.take_along_axis(nll, y[..., None], axis=-1)[..., 0]
    assert bool(jnp.any((lse - tgt > PROB_FLOOR_CLAMP) & (mask > 0)))
    # positions within fp-rounding of the floor can clamp differently
    # between the exp-then-max and the direct lse-tgt threshold; each such
    # position contributes at most ~eps*|lse| to a SUM-scale loss
    np.testing.assert_allclose(float(lc), float(lm), rtol=1e-4)
    for a, bb in zip(gc, gm):
        np.testing.assert_allclose(np.asarray(a), np.asarray(bb),
                                   rtol=1e-4, atol=1e-5)
