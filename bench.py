"""Benchmark: decode and train-step times on one GPU, one JSON line.

Sections (each a plain function; any failure fails the run):

- ``decode``      — the flagship beam (StyleNet, V=8192, H=F=512, k=5, 40
                    steps, B=1024 images) and the attention beam (196x2048
                    spatial features, B=128);
- ``train``       — the flagship factual train step (fwd + bwd + clip +
                    Adam) at B=64 and B=512 and the attention step at B=64,
                    chunked CE on and off.

Every time is the median of several calls after a warm-up, each ending in
``block_until_ready``; an A/B is taken in the order A, B, B, A.  The output
names the device and the card's power limit.  Refuses to run off the GPU.

Run: ``python bench.py [--sections decode,train]``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from chip_smoke import card_line, timed_ms

V, E, H, F, FS, P, A, K, STEPS = 8192, 300, 512, 512, 2048, 196, 512, 5, 40


def _abba(fa, fb, args, reps):
    t = [timed_ms(f, *args, reps=reps) for f in (fa, fb, fb, fa)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def bench_decode(reps: int = 3) -> list:
    import jax
    import jax.numpy as jnp

    from icee_tpu.core.config import AttentionDecoderConfig, DecoderConfig
    from icee_tpu.decode.fast import beam_fn
    from icee_tpu.models import attention as att_mod
    from icee_tpu.models import factored_lstm as fl

    rng = np.random.default_rng(0)
    out = []
    cases = [
        ("stylenet", 1024, fl.init_params(jax.random.PRNGKey(0), DecoderConfig(
            vocab_size=V, embed_size=E, hidden_size=H, factored_size=F)),
         (1024, E)),
        ("stylenet_att", 128, att_mod.init_factored_att_params(
            jax.random.PRNGKey(0), AttentionDecoderConfig(
                vocab_size=V, embed_size=E, hidden_size=H, factored_size=F,
                attention_size=A, feature_size=FS)), (128, P, FS)),
    ]
    for family, batch, dec, shape in cases:
        x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
        ms = timed_ms(beam_fn(family, dec, batch, K, STEPS, V, 1, 2), x, 1,
                      reps=reps)
        out.append({"family": family, "batch": batch, "ms": ms,
                    "captions_per_s": batch / ms * 1e3})
        print(json.dumps(out[-1]), flush=True)
    return out


def bench_train(reps: int = 5) -> list:
    import jax
    import jax.numpy as jnp

    from icee_tpu.core.config import (
        AttentionDecoderConfig, DecoderConfig, EncoderConfig, TrainConfig)
    from icee_tpu.models import attention as att_mod
    from icee_tpu.models import encoder as enc_mod
    from icee_tpu.models import factored_lstm as fl
    from icee_tpu.train import optim
    from icee_tpu.train.steps import make_attention_steps, make_caption_steps

    rng = np.random.default_rng(0)
    out = []
    t = 42
    for family, batch in (("stylenet", 64), ("stylenet", 512),
                          ("stylenet_att", 64)):
        att = family.endswith("_att")
        caps = jnp.asarray(rng.integers(4, V, (batch, t)), jnp.int32)
        lens = jnp.asarray(rng.integers(8, t, (batch,)), jnp.int32)
        mask = jnp.ones((batch,), bool)
        key = jax.random.PRNGKey(1)
        if att:
            cfg = AttentionDecoderConfig(vocab_size=V, attention_size=A)
            dec = att_mod.init_factored_att_params(key, cfg)
            feats = jnp.asarray(rng.standard_normal((batch, P, FS)),
                                jnp.float32)
        else:
            cfg = DecoderConfig(vocab_size=V)
            dec = fl.init_params(key, cfg)
            head = enc_mod.init_head_params(key, EncoderConfig())
            feats = jnp.asarray(rng.standard_normal((batch, FS)),
                                jnp.float32)
        steps = {}
        for chunked in (False, True):
            tcfg = TrainConfig(chunked_ce=chunked)
            opt = optim.make_adam(tcfg.lr_caption, tcfg)
            step = (make_attention_steps if att else make_caption_steps)(
                cfg, tcfg, opt, opt, True)[0]
            if att:
                state = opt.init(dec)
                steps[chunked] = (lambda s=step, st=state: s(
                    dec, st, feats, caps, lens, mask, key))
            else:
                state = opt.init((dec, head))
                steps[chunked] = (lambda s=step, st=state: s(
                    dec, head, st, feats, caps, lens, mask, key))
        off_ms, on_ms = _abba(steps[False], steps[True], (), reps)
        out.append({"family": family, "batch": batch,
                    "chunked_off_ms": off_ms, "chunked_on_ms": on_ms})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sections", default="decode,train")
    args = ap.parse_args(argv)
    from icee_tpu.core import backend

    card = card_line()
    devices = backend.require_gpu()
    backend.enable_compile_cache()
    fns = {"decode": bench_decode, "train": bench_train}
    results = {name: fns[name]() for name in args.sections.split(",")}
    print(json.dumps({"device": {"platform": devices[0].platform,
                                 "kind": devices[0].device_kind,
                                 "count": len(devices)},
                      "card": card, "results": results}), flush=True)


if __name__ == "__main__":
    main()
