"""``chip_smoke.py`` off the card: its phases at tiny widths on the CPU, its
refusal to run anywhere but on a GPU, and the exact last line it prints.

The phases are the ones the card runs; only the widths are cut here, so a
wrong path, argument or comparison shows before a chip run."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TINY = chip_smoke.Widths(
    vocab=96, embed=8, hidden=16, factored=16, attention=8, image=32, k=3,
    steps=5, decode_batch=4, train_batch=8, n_train=8, n_val=4, n_styled=16,
    timing_reps=1)
TINY_FLAGS = ("--embed_size", "8", "--hidden_size", "16", "--factored_size",
              "16", "--attention_size", "8", "--max_seq_length", "5")


@pytest.mark.parametrize("size", [8, 96, 8192])
def test_seeded_vocab_has_exactly_the_size(size):
    words = ["seorang", "anak", "bermain"]
    v = chip_smoke.seeded_vocab(size, seed=0, words=words)
    assert len(v) == size
    assert all(w in v.word2idx for w in words[:max(0, size - 4)])
    again = chip_smoke.seeded_vocab(size, seed=0, words=words)
    assert v.idx2word == again.idx2word


def test_refuses_a_platform_other_than_gpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "card, 0 W")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("four_cards", [False, True])
def test_last_line_names_the_device(monkeypatch, capsys, tmp_path,
                                    four_cards):
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
           "count": 4 if four_cards else 1, "card": "H100, 700.00 W"}
    ran = []
    monkeypatch.setattr(chip_smoke, "phase_device", lambda count: dev)
    for name in ("phase_kernel", "phase_serving", "phase_training",
                 "phase_four_cards"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, **k: ran.append(_n) or {})
    argv = ["--out", str(tmp_path)] + (["--four-cards"] if four_cards
                                       else [])
    assert chip_smoke.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": dev["count"]}}
    assert "H100, 700.00 W" in lines[-2]
    assert ran == (["phase_four_cards"] if four_cards else
                   ["phase_kernel", "phase_serving", "phase_training"])


def test_phase_kernel_times_the_decode():
    out = chip_smoke.phase_kernel("cpu", TINY, gpu_tests=False)
    assert out["kernels_kept"] == [] and out["decode_xla_ms"] > 0


def test_phase_serving_answers_every_variant_and_mode(tmp_path):
    from icee_tpu.core.config import (
        AttentionDecoderConfig, DecoderConfig, EncoderConfig)

    kw = dict(vocab_size=TINY.vocab, embed_size=TINY.embed,
              hidden_size=TINY.hidden, factored_size=TINY.factored,
              max_seq_length=TINY.steps)
    out = chip_smoke.phase_serving(
        str(tmp_path), TINY, dec_cfg=DecoderConfig(**kw),
        att_cfg=AttentionDecoderConfig(attention_size=TINY.attention, **kw),
        enc_cfg=EncoderConfig(embed_size=TINY.embed),
        gain_bias={v: (1.0, 0.0) for v in chip_smoke.SERVE_GAIN_BIAS})
    assert out["same_highest"] == 1.0
    assert out["nonempty"] > 0      # the comparison sees real captions
    assert 0.0 <= out["same_default"] <= 1.0
    assert "CompiledMemoryStats" in out["decode_memory"]


def test_phase_training_matches_the_plain_step(tmp_path):
    out = chip_smoke.phase_training(
        str(tmp_path), TINY, widths_flags=TINY_FLAGS,
        cfg_overrides={"max_seq_length": TINY.steps})
    assert set(out) == {"stylenet", "stylenet_att"}
    for res in out.values():
        assert len(res["ref"]) == 3 and np.all(np.isfinite(res["ref"]))
        assert res["rel_highest"] <= 1e-4


def test_phase_four_cards_matches_one_device(tmp_path):
    assert len(jax.devices()) >= 4
    out = chip_smoke.phase_four_cards(str(tmp_path), TINY, global_batch=16,
                                      gain_bias=(1.0, 0.0))
    assert out["decode"]["same_tokens"]
    for shape in ("mesh(4, 1)", "mesh(2, 2)"):
        assert out[shape]["rel"] <= 1e-4
