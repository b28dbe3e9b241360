"""utils (profiling, metrics logging, embeddings) + tooling CLIs +
NIC-att import shim."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icee_tpu.utils.embeddings import load_embeddings
from icee_tpu.utils.logging import MetricsLogger
from icee_tpu.utils.profiling import StepTimer


def test_step_timer_discards_warmup():
    t = StepTimer(warmup=2)
    for _ in range(5):
        with t:
            pass
    s = t.summary()
    assert s["steps"] == 3 and "p95_ms" in s


def test_metrics_logger_jsonl(tmp_path):
    p = tmp_path / "m.jsonl"
    log = MetricsLogger(str(p))
    log.log("epoch", loss=1.5, epoch=0)
    log.log("decay", lr=2e-4)
    recs = [json.loads(l) for l in p.read_text().splitlines()]
    assert recs[0]["event"] == "epoch" and recs[0]["loss"] == 1.5
    assert recs[1]["lr"] == 2e-4
    # disabled logger is a no-op
    MetricsLogger(None).log("x")


def test_load_embeddings_glove_format(tmp_path):
    f = tmp_path / "emb.txt"
    f.write_text("anjing 0.1 0.2 0.3\nkucing -1 0 1\nunknownword 9 9 9\n")
    word_map = {"anjing": 0, "bola": 1, "kucing": 2}
    emb, dim = load_embeddings(str(f), word_map)
    assert dim == 3 and emb.shape == (3, 3)
    np.testing.assert_allclose(emb[0], [0.1, 0.2, 0.3])
    np.testing.assert_allclose(emb[2], [-1, 0, 1])
    # missing word initialized within the reference bound sqrt(3/dim)
    assert np.all(np.abs(emb[1]) <= np.sqrt(3 / 3) + 1e-6)


def test_nic_att_import_shapes(rng):
    import torch

    from icee_tpu.checkpoint.torch_import import (
        import_nic_att_decoder_state_dict)

    e, h, v, fs, a = 8, 12, 20, 16, 10
    sd = {
        "embed.weight": torch.randn(v, e),
        "lstm.weight_ih": torch.randn(4 * h, e + fs),
        "lstm.weight_hh": torch.randn(4 * h, h),
        "lstm.bias_ih": torch.randn(4 * h),
        "lstm.bias_hh": torch.randn(4 * h),
        "linear.weight": torch.randn(v, h),
        "linear.bias": torch.randn(v),
        "attention.encoder_att.weight": torch.randn(a, fs),
        "attention.encoder_att.bias": torch.randn(a),
        "attention.decoder_att.weight": torch.randn(a, h),
        "attention.decoder_att.bias": torch.randn(a),
        "attention.full_att.weight": torch.randn(1, a),
        "attention.full_att.bias": torch.randn(1),
        "init_h.weight": torch.randn(h, fs),
        "init_h.bias": torch.randn(h),
        "init_c.weight": torch.randn(h, fs),
        "init_c.bias": torch.randn(h),
        "f_beta.weight": torch.randn(fs, h),
        "f_beta.bias": torch.randn(fs),
    }
    params = import_nic_att_decoder_state_dict(sd)
    # drives the imported decoder end to end
    from icee_tpu.core.config import AttentionDecoderConfig
    from icee_tpu.models.attention import rnn_att_decode_step

    feats = jnp.asarray(rng.standard_normal((3, 6, fs)).astype(np.float32))
    emb = jnp.asarray(rng.standard_normal((3, e)).astype(np.float32))
    h0 = jnp.zeros((3, h))
    logits, alpha, _ = rnn_att_decode_step(params, emb, feats, (h0, h0))
    assert logits.shape == (3, v) and alpha.shape == (3, 6)


def test_exporter_and_inspector_roundtrip(tmp_path, tiny_vocab):
    """X1/X2 tooling: export a bare ckpt to the full format, inspect it."""
    import sys

    from icee_tpu.checkpoint.ckpt import CheckpointState, save_checkpoint
    from icee_tpu.core.config import DecoderConfig, EncoderConfig, TrainConfig
    from icee_tpu.models import encoder as enc_mod
    from icee_tpu.models import factored_lstm as fl
    from icee_tpu.train import optim

    tiny_vocab.save(str(tmp_path / "vocab.pkl"))
    cfg = DecoderConfig(vocab_size=len(tiny_vocab), embed_size=8,
                        hidden_size=12, factored_size=12)
    dec = fl.init_params(jax.random.PRNGKey(3), cfg)
    head = enc_mod.init_head_params(jax.random.PRNGKey(4),
                                    EncoderConfig(embed_size=8))
    tx = optim.make_adam(1e-3, TrainConfig())
    bare = CheckpointState(
        epoch=1, epochs_since_improvement={"factual": 0, "emotion": 0},
        best_bleu4={"factual": 0.0, "emotion": 0.0},
        params={"decoder": dec, "head": head},
        opt_states={"optimizer": tx.init((dec, head))})
    src = save_checkpoint(str(tmp_path), "bare", "FAC", bare, False)

    import argparse

    from icee_tpu.cli.export import main as export_main
    from icee_tpu.cli.common import add_model_flags

    p = argparse.ArgumentParser()
    for flag, kw in [("--decoder_path", {}), ("--encoder_path", {}),
                     ("--vocab_path", {}), ("--out_dir", {}),
                     ("--data_name", {}), ("--mode", {})]:
        p.add_argument(flag, default=None, **kw)
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--bleu4", type=float, default=0.0)
    p.add_argument("--best", action="store_true")
    add_model_flags(p)
    args = p.parse_args([
        "--decoder_path", src, "--vocab_path", str(tmp_path / "vocab.pkl"),
        "--out_dir", str(tmp_path / "exported"), "--data_name", "toy",
        "--mode", "factual", "--epoch", "8", "--bleu4", "0.0347",
        "--embed_size", "8", "--hidden_size", "12", "--factored_size", "12",
    ])
    export_main(args)
    import os

    assert os.path.isdir(str(tmp_path / "exported" / "FAC_checkpoint_toy"))

    from icee_tpu.cli.inspect_ckpt import main as inspect_main

    p2 = argparse.ArgumentParser()
    p2.add_argument("--checkpoint_path")
    p2.add_argument("--vocab_path")
    add_model_flags(p2)
    inspect_main(p2.parse_args([
        "--checkpoint_path", str(tmp_path / "exported" / "FAC_checkpoint_toy"),
        "--vocab_path", str(tmp_path / "vocab.pkl"),
        "--embed_size", "8", "--hidden_size", "12", "--factored_size", "12",
    ]))
