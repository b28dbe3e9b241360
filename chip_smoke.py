"""Bring-up smoke run: the caption service and the trainers on one GPU.

Drives the system's main path once, through the entry points a user calls,
at the flagship widths (StyleNet FactoredLSTM V=8192, E=300, H=F=512, beam
k=5 over 40 steps; attention over 196x2048 spatial features; ResNet-152 at
224x224) with random weights made from a seed:

1. device   — the card's name and power limit (``nvidia-smi``, run in a
               child that stays off JAX), then ``jax.devices()``.  Anything
               but a GPU fails the run: there is no CPU fallback.
2. kernels  — no hand-written kernel is kept (the head + top-k kernel lost
               its end-to-end A/B to XLA on the card, docs/KERNELS.md): the
               card-only tests run, and the flagship decode (B=1024 images
               x k=5 x 40 steps) is timed on XLA's path.
3. serving  — the HTTP service (``serve/app.py``, ``CaptionEngine`` +
               ``BatchingEngine``) answers ``POST /generate`` for all four
               modes with the committed JPEGs; every variant's captions are
               compared with ``decode/beam.py::beam_search`` per image.  The
               random decoders are scaled (:data:`SERVE_GAIN_BIAS`) so that
               their beams reach ``<end>``.
4. training — ``icee-train --trainer multitask`` for the StyleNet and the
               attention family at B=64 on a corpus from
               ``scripts/gen_synth_corpus.py``; the first steps' losses are
               compared with the plain materialized-loss step at
               ``"highest"`` precision.

``--four-cards`` runs only the four-card phase: ``MultitaskTrainer`` on
(4, 1) and (2, 2) meshes and the data-parallel beam decode, each compared
with one card.

Every phase's failure propagates; the last line of standard output is one
JSON object naming the device.  Run: ``python chip_smoke.py [--four-cards]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import icee_tpu  # noqa: F401  (fails outside a checkout of this repo)

ROOT = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Widths:
    """Model and run sizes; :data:`FLAGSHIP` is what the card runs."""

    vocab: int = 8192
    embed: int = 300
    hidden: int = 512
    factored: int = 512
    feature: int = 2048
    attention: int = 512
    grid: int = 196
    image: int = 224
    k: int = 5
    steps: int = 40
    decode_batch: int = 1024
    train_batch: int = 64
    n_train: int = 256           # x 5 captions = 20 batches of 64
    n_val: int = 64
    n_styled: int = 480
    timing_reps: int = 5


FLAGSHIP = Widths()


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card, read by a child off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, *args, reps: int = 5) -> float:
    """Median wall time of ``fn(*args)`` over ``reps`` calls after one
    warm-up, each ending in ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# --- 1. device ---------------------------------------------------------------

def phase_device(count: int = 1) -> dict:
    card = card_line()
    log(f"[device] card: {card}")
    from icee_tpu.core import backend

    devices = backend.require_gpu()
    if len(devices) < count:
        raise RuntimeError(f"needs {count} GPUs, JAX found {len(devices)}")
    backend.enable_compile_cache()
    log(f"[device] {backend.device_line()}")
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices), "card": card}


# --- 2. kernels ----------------------------------------------------------------

def run_gpu_tests() -> int:
    """The card-only tests (``-m gpu``) in this process; returns how many
    passed and fails if any failed or none ran."""
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    counter = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[counter])
    if rc != 0 or counter.passed == 0:
        raise AssertionError(f"card-only tests: exit {rc}, "
                             f"{counter.passed} passed")
    return counter.passed


def phase_kernel(card: str, w: Widths = FLAGSHIP, seed: int = 0,
                 gpu_tests: bool = True) -> dict:
    """No hand-written kernel is kept (each lost its A/B to XLA on the
    card, docs/KERNELS.md): run the card-only tests and time the XLA path
    of the flagship decode."""
    import jax
    import jax.numpy as jnp

    from icee_tpu.core.config import DecoderConfig
    from icee_tpu.decode.fast import beam_fn
    from icee_tpu.models import factored_lstm as fl

    out = {"kernels_kept": []}
    if gpu_tests:
        out["gpu_tests_passed"] = run_gpu_tests()
        log(f"[kernel] card-only tests (-m gpu): "
            f"{out['gpu_tests_passed']} passed")
    cfg = DecoderConfig(vocab_size=w.vocab, embed_size=w.embed,
                        hidden_size=w.hidden, factored_size=w.factored,
                        max_seq_length=w.steps)
    dec = fl.init_params(jax.random.PRNGKey(seed), cfg)
    feats = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (w.decode_batch, w.embed)), jnp.float32)
    fn = beam_fn("stylenet", dec, w.decode_batch, w.k, w.steps, w.vocab,
                 1, 2)
    ms = timed_ms(fn, feats, 1, reps=w.timing_reps)
    out["decode_xla_ms"] = ms
    log(f"[kernel] no hand-written kernel kept (docs/KERNELS.md); XLA "
        f"flagship decode B={w.decode_batch} x k={w.k} x {w.steps} steps: "
        f"{ms:.2f} ms per batch, {w.decode_batch / ms * 1e3:.0f} "
        f"captions/s ({card})")
    return out


# --- 3. serving ----------------------------------------------------------------

def seeded_vocab(size: int, seed: int = 0, words=()):
    """A vocabulary of exactly ``size`` entries: the specials, ``words``,
    then seeded filler words."""
    from icee_tpu.data.vocab import SPECIALS, Vocabulary

    v = Vocabulary()
    for s in SPECIALS:
        v.add_word(s)
    for word in words:
        if len(v) < size:
            v.add_word(word)
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnoprstuwy"))
    while len(v) < size:
        v.add_word("".join(rng.choice(letters, 7)))
    return v


# (gain, <end> bias) per family for the served random decoders.  A decoder
# at its plain random init is close to a fixed unigram model whose beams
# never reach <end> within 40 steps at V=8192, so every caption would be the
# reference's empty fallback and the caption comparison would see nothing.
# Scaling every weight by the gain makes the step depend on its state, and
# the bias puts <end> within reach: at the flagship widths most families
# then end their captions at varied lengths (NIC's saturates either way).
SERVE_GAIN_BIAS = {"stylenet": (8.0, 8.0), "stylenet_att": (4.0, 4.0),
                   "nic_att": (8.0, 6.0), "nic": (1.0, 0.0)}


def sharpen_decoders(engine, gain_bias=SERVE_GAIN_BIAS) -> None:
    """Apply ``gain_bias`` to every served decoder in place of
    the plain init (before the first request compiles anything); pipelines
    that share a decoder keep sharing it."""
    import jax

    end = engine.vocab.end
    for variant, modes in engine.models.items():
        gain, bias = gain_bias[variant]
        new = {}
        for pipe in modes.values():
            dec = pipe["decoder"]
            if id(dec) not in new:
                d = jax.tree_util.tree_map(lambda x: x * gain, dec)
                b = "C_b" if "C_b" in d else "linear_b"
                d[b] = d[b].at[end].add(bias)
                new[id(dec)] = d
            pipe["decoder"] = new[id(dec)]


def _post(port: int, path: str, mode: str) -> dict:
    import urllib.request

    boundary = "icee-smoke-boundary"
    with open(path, "rb") as f:
        data = f.read()
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
            f" filename=\"{os.path.basename(path)}\"\r\nContent-Type: "
            f"image/jpeg\r\n\r\n").encode() + data + \
        f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate?mode={mode}", data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def phase_serving(work: str, w: Widths = FLAGSHIP, seed: int = 0,
                  dec_cfg=None, att_cfg=None, enc_cfg=None,
                  gain_bias=SERVE_GAIN_BIAS,
                  image_dir: str = os.path.join(ROOT, "examples/data/img")
                  ) -> dict:
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from icee_tpu.core.config import MODES, mode_id
    from icee_tpu.serve.app import serve
    from icee_tpu.serve.batching import BatchingEngine
    from icee_tpu.serve.config import MODEL_VARIANTS, ServeConfig
    from icee_tpu.serve.engine import CaptionEngine

    os.makedirs(work, exist_ok=True)
    vocab_path = os.path.join(work, "vocab.pkl")
    seeded_vocab(w.vocab, seed).save(vocab_path)
    images = sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir)
                    if f.endswith(".jpg"))
    n = len(images)
    cfg = ServeConfig(backend_host="127.0.0.1", backend_port=0,
                      image_folder=os.path.join(work, "uploads"),
                      vocab_path=vocab_path)
    engine = CaptionEngine(cfg, smoke_mode=True, image_size=w.image,
                           dec_cfg=dec_cfg, att_cfg=att_cfg, enc_cfg=enc_cfg)
    sharpen_decoders(engine, gain_bias)
    batcher = BatchingEngine(engine, window_ms=200.0, max_batch=n, k=w.k)
    httpd = serve(cfg, engine=batcher)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    out = {}
    try:
        # the service, end to end: every mode, all images at once
        t0 = time.perf_counter()
        answers = {}
        with ThreadPoolExecutor(n) as pool:
            for mode in MODES:
                answers[mode] = list(pool.map(
                    lambda p, m=mode: _post(port, p, m), images))
        out["http_s"] = time.perf_counter() - t0
        for mode in MODES:
            for a in answers[mode]:
                for v in MODEL_VARIANTS:
                    if not isinstance(a.get(v), str) or a[v] == "-":
                        raise AssertionError(f"no {v} caption for {mode}: {a}")
        log(f"[serving] POST /generate: {n} images x {len(MODES)} modes "
            f"answered for {list(MODEL_VARIANTS)} in {out['http_s']:.1f} s "
            f"(groups {batcher.group_sizes})")
        log(f"[serving] e.g. happy -> {answers['happy'][0]}")

        # the same decodes against beam_search per image
        feats = [engine._features(engine.decode_image(p)) for p in images]
        pooled = jnp.concatenate([f[0] for f in feats])
        spatial = jnp.concatenate([f[1] for f in feats])

        def served(variant, mode):
            pipe = engine.models[variant][mode]
            if variant.endswith("_att"):
                x = spatial
            else:
                from icee_tpu.models import encoder as enc_mod

                x, _ = enc_mod.encode_global_from_pooled(pipe["head"],
                                                         pooled, train=False)
            res = batcher._batched_decode_fn(variant, mode, n)(
                x, jnp.asarray(mode_id(mode)))
            ref = jax.vmap(engine._decode_fn(variant, mode),
                           in_axes=(0, None))(x[:, None],
                                              jnp.asarray(mode_id(mode)))
            return ([engine._detok(t, l) for t, l in zip(res.tokens,
                                                         res.length)],
                    [engine._detok(t, l) for t, l in zip(ref.tokens,
                                                         ref.length)])

        with jax.default_matmul_precision("highest"):
            high = {(v, m): served(v, m) for v in MODEL_VARIANTS
                    for m in MODES}
        default = {(v, m): served(v, m)[0] for v in MODEL_VARIANTS
                   for m in MODES}
        total = len(high) * n
        same_high = sum(a == b for got, ref in high.values()
                        for a, b in zip(got, ref))
        same_default = sum(a == b for key, got in default.items()
                           for a, b in zip(got, high[key][1]))
        http_same = sum(
            answers[m][i][v] == high[(v, m)][1][i]
            for v in MODEL_VARIANTS for m in MODES for i in range(n))
        # with random weights a beam rarely reaches <end> within the step
        # limit, and then the caption is the reference's empty fallback
        nonempty = sum(bool(c) for _, ref in high.values() for c in ref)
        out.update(same_highest=same_high / total,
                   same_default=same_default / total,
                   http_same_default=http_same / total,
                   nonempty=nonempty / total)
        log(f"[serving] batched decode vs beam_search per image, "
            f"{len(MODEL_VARIANTS)} variants x {len(MODES)} modes x {n} "
            f"images: identical {same_high}/{total} at highest; "
            f"{same_default}/{total} at default precision; HTTP answers "
            f"{http_same}/{total}; non-empty captions {nonempty}/{total}")
        if same_high != total:
            bad = [(k, a, b) for k, (got, ref) in high.items()
                   for a, b in zip(got, ref) if a != b][:3]
            raise AssertionError(f"captions differ at highest: {bad}")

        fn = batcher._batched_decode_fn("stylenet", "happy", n)
        x = jnp.zeros((n, engine.dec_cfg.embed_size), jnp.float32)
        mem = fn.lower(x, jnp.asarray(1)).compile().memory_analysis()
        out["decode_memory"] = str(mem)
        log(f"[serving] stylenet decode program memory_analysis: {mem}")
        stats = jax.devices()[0].memory_stats() or {}
        out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        log(f"[serving] peak_bytes_in_use: {out['peak_bytes_in_use']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    return out


# --- 4. training ---------------------------------------------------------------

def make_corpus(work: str, w: Widths, spatial: bool, seed: int = 0) -> str:
    """``scripts/gen_synth_corpus.py`` in a child (it stays off JAX) plus a
    vocabulary padded to ``w.vocab`` entries; returns the corpus dir."""
    from icee_tpu.data.vocab import build_vocab

    out = os.path.join(work, "corpus_spatial" if spatial else "corpus")
    cmd = [sys.executable, os.path.join(ROOT, "scripts/gen_synth_corpus.py"),
           "--out", out, "--n_train", str(w.n_train), "--n_val",
           str(w.n_val), "--n_test", "0", "--n_styled", str(w.n_styled),
           "--seed", str(seed)]
    if spatial:
        cmd.append("--spatial")
    subprocess.run(cmd, check=True, timeout=600)
    words = build_vocab(os.path.join(out, "vocab_src.txt"),
                        threshold=1).idx2word.values()
    seeded_vocab(w.vocab, seed, words).save(os.path.join(out, "vocab.pkl"))
    return out


def run_train_cli(corpus: str, work: str, w: Widths, attention: bool,
                  widths_flags=()) -> float:
    """``icee-train --trainer multitask[_att] --family stylenet`` for one
    epoch through the console-script path; returns its wall seconds."""
    import runpy

    tag = "att" if attention else "stylenet"
    argv = ["icee-train", "--trainer",
            "multitask_att" if attention else "multitask",
            "--family", "stylenet", "--mode", "happy",
            "--vocab_path", os.path.join(corpus, "vocab.pkl"),
            "--caption_path", os.path.join(corpus, "train.txt"),
            "--val_caption_path", os.path.join(corpus, "val.txt"),
            "--happy_path", os.path.join(corpus, "happy.txt"),
            "--val_happy_path", os.path.join(corpus, "val_happy.txt"),
            "--feature_cache", os.path.join(corpus, "features.npz"),
            "--num_epochs", "1",
            "--caption_batch_size", str(w.train_batch),
            "--model_path", os.path.join(work, f"models_{tag}"),
            "--log_path", os.path.join(work, f"train_{tag}.log"),
            "--log_step", "5", "--log_step_emotion", "5",
            *widths_flags]
    saved = sys.argv
    sys.argv = argv
    t0 = time.perf_counter()
    try:
        runpy.run_module("icee_tpu.cli.train", run_name="__main__")
    finally:
        sys.argv = saved
    return time.perf_counter() - t0


def compare_train_steps(corpus: str, w: Widths, attention: bool,
                        n_steps: int = 3, seed: int = 0,
                        cfg_overrides=None) -> dict:
    """The first ``n_steps`` factual losses of the production step against
    the plain materialized-loss step at ``"highest"``, same params, batches
    and RNG; plus the production step at default precision."""
    import jax
    import jax.numpy as jnp

    from icee_tpu.core.config import (
        AttentionDecoderConfig, DecoderConfig, EncoderConfig, TrainConfig)
    from icee_tpu.data import load_caption_dataset
    from icee_tpu.data.pipeline import caption_dataset_loader
    from icee_tpu.data.vocab import load_vocab
    from icee_tpu.models import attention as att_mod
    from icee_tpu.models import encoder as enc_mod
    from icee_tpu.models import factored_lstm as fl
    from icee_tpu.train import optim
    from icee_tpu.train.steps import make_attention_steps, make_caption_steps

    vocab = load_vocab(os.path.join(corpus, "vocab.pkl"))
    feats = dict(np.load(os.path.join(corpus, "features.npz")))
    kw = dict(vocab_size=len(vocab), embed_size=w.embed,
              hidden_size=w.hidden, factored_size=w.factored,
              feature_size=w.feature, **(cfg_overrides or {}))
    if attention:
        cfg = AttentionDecoderConfig(attention_size=w.attention, **kw)
        dec = att_mod.init_factored_att_params(jax.random.PRNGKey(seed), cfg)
        head = None
    else:
        cfg = DecoderConfig(**kw)
        dec = fl.init_params(jax.random.PRNGKey(seed), cfg)
        head = enc_mod.init_head_params(
            jax.random.PRNGKey(seed + 1),
            EncoderConfig(embed_size=w.embed, feature_size=w.feature))
    ds = load_caption_dataset(os.path.join(corpus, "train.txt"), vocab)
    batches = list(caption_dataset_loader(
        ds, batch_size=w.train_batch, max_len=cfg.max_seq_length + 2,
        image_provider=lambda name: feats[name], shuffle=False))[:n_steps]
    make = make_attention_steps if attention else make_caption_steps

    def losses(chunked):
        tcfg = TrainConfig(chunked_ce=chunked)
        opt = optim.make_adam(tcfg.lr_caption, tcfg)
        step = make(cfg, tcfg, opt, opt, True)[0]
        d, hd = dec, head
        state = opt.init(d if attention else (d, hd))
        key = jax.random.PRNGKey(seed + 2)
        out = []
        for b in batches:
            args = (jnp.asarray(b.images), jnp.asarray(b.captions),
                    jnp.asarray(b.lengths), jnp.asarray(b.sample_mask), key)
            if attention:
                d, state, loss = step(d, state, *args)
            else:
                d, hd, state, loss = step(d, hd, state, *args)
            out.append(float(loss))
        lowered = (step.lower(d, state, *args) if attention
                   else step.lower(d, hd, state, *args))
        return out, lowered

    with jax.default_matmul_precision("highest"):
        ref, _ = losses(False)
        prod_high, lowered = losses(None)
    prod_default, _ = losses(None)
    rel = lambda a: float(np.max(np.abs(np.subtract(a, ref))  # noqa: E731
                                 / np.abs(ref)))
    return {"ref": ref, "prod_highest": prod_high,
            "prod_default": prod_default, "rel_highest": rel(prod_high),
            "rel_default": rel(prod_default),
            "memory": str(lowered.compile().memory_analysis())}


def phase_training(work: str, w: Widths = FLAGSHIP, seed: int = 0,
                   widths_flags=(), cfg_overrides=None) -> dict:
    out = {}
    for attention in (False, True):
        tag = "stylenet_att" if attention else "stylenet"
        corpus = make_corpus(work, w, spatial=attention, seed=seed)
        secs = run_train_cli(corpus, work, w, attention, widths_flags)
        log(f"[training] icee-train multitask{'_att' if attention else ''}"
            f" --family stylenet: one epoch at B={w.train_batch} in "
            f"{secs:.1f} s (compile included)")
        cmp = compare_train_steps(corpus, w, attention, seed=seed,
                                  cfg_overrides=cfg_overrides)
        log(f"[training] {tag} first losses {cmp['prod_default']} (default "
            f"precision); vs plain step at highest: rel err "
            f"{cmp['rel_highest']:.2e} at highest, {cmp['rel_default']:.2e} "
            f"at default")
        log(f"[training] {tag} train step memory_analysis: {cmp['memory']}")
        if not cmp["rel_highest"] <= 1e-4:
            raise AssertionError(f"{tag} losses differ from the reference: "
                                 f"{cmp}")
        out[tag] = dict(cmp, epoch_s=secs)
    return out


# --- four cards ------------------------------------------------------------------

def phase_four_cards(work: str, w: Widths = FLAGSHIP, seed: int = 0,
                     n_devices: int = 4, global_batch: int = 256,
                     n_steps: int = 3,
                     gain_bias=SERVE_GAIN_BIAS["stylenet"]) -> dict:
    """MultitaskTrainer steps on (4, 1) and (2, 2) meshes and the
    data-parallel beam, each against one card."""
    import jax
    import jax.numpy as jnp

    from icee_tpu.core.config import DecoderConfig, EncoderConfig, TrainConfig
    from icee_tpu.data import load_caption_dataset
    from icee_tpu.data.pipeline import caption_dataset_loader
    from icee_tpu.data.vocab import load_vocab
    from icee_tpu.decode.fast import beam_fn, sharded_beam_fn
    from icee_tpu.models import encoder as enc_mod
    from icee_tpu.models import factored_lstm as fl
    from icee_tpu.parallel.mesh import make_mesh
    from icee_tpu.train.loops import MultitaskTrainer

    devices = jax.devices()[:n_devices]
    corpus = make_corpus(work, w, spatial=False, seed=seed)
    vocab = load_vocab(os.path.join(corpus, "vocab.pkl"))
    feats = dict(np.load(os.path.join(corpus, "features.npz")))
    cfg = DecoderConfig(vocab_size=len(vocab), embed_size=w.embed,
                        hidden_size=w.hidden, factored_size=w.factored,
                        feature_size=w.feature)
    ecfg = EncoderConfig(embed_size=w.embed, feature_size=w.feature)
    ds = load_caption_dataset(os.path.join(corpus, "train.txt"), vocab)
    batches = list(caption_dataset_loader(
        ds, batch_size=global_batch, max_len=cfg.max_seq_length + 2,
        image_provider=lambda name: feats[name], shuffle=False))[:n_steps]

    def losses(shape):
        mesh = None if shape is None else make_mesh(
            shape, devices=devices)
        tr = MultitaskTrainer(
            cfg, TrainConfig(caption_batch_size=global_batch), vocab,
            fl.init_params(jax.random.PRNGKey(seed), cfg),
            enc_mod.init_head_params(jax.random.PRNGKey(seed + 1), ecfg),
            sample_fn=lambda *a: ["<end>"], model_dir=os.path.join(
                work, f"four_{shape}"), mesh=mesh)
        out = []
        for b in batches:
            x = tr._to_device(b.images, b.captions, b.lengths, b.sample_mask)
            tr.dec, tr.head, tr.opt_state, loss = tr.factual_step(
                tr.dec, tr.head, tr.opt_state, *x, tr._next_rng())
            out.append(float(loss))
        if mesh is not None:
            # every parameter and optimizer leaf spans the whole mesh (none
            # left on the first device alone)
            spans = {len(leaf.sharding.device_set) for leaf in
                     jax.tree_util.tree_leaves((tr.dec, tr.head,
                                                tr.opt_state))
                     if hasattr(leaf, "sharding")}
            if spans != {len(devices)}:
                raise AssertionError(f"mesh {shape}: leaves span {spans} "
                                     f"devices, want {len(devices)}")
        return out

    out = {}
    with jax.default_matmul_precision("highest"):
        one = losses(None)
        for shape in ((n_devices, 1), (n_devices // 2, 2)):
            got = losses(shape)
            rel = float(np.max(np.abs(np.subtract(got, one)) / np.abs(one)))
            out[f"mesh{shape}"] = {"losses": got, "rel": rel}
            log(f"[four-cards] MultitaskTrainer mesh {shape}: losses {got} "
                f"vs one card {one}: rel err {rel:.2e}")
            if not rel <= 1e-4:
                raise AssertionError(f"mesh {shape} losses differ: {out}")

    # the served StyleNet's gain and <end> bias (SERVE_GAIN_BIAS), so that
    # beams end at varied lengths and a misplaced row would show
    gain, bias = gain_bias
    dec = jax.tree_util.tree_map(
        lambda a: a * gain, fl.init_params(jax.random.PRNGKey(seed + 3), cfg))
    dec["C_b"] = dec["C_b"].at[vocab.end].add(bias)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (w.decode_batch, w.embed)), jnp.float32)
    kw = dict(k=w.k, max_seq_length=w.steps, vocab_size=cfg.vocab_size,
              start_token=vocab.start, end_token=vocab.end)
    single = beam_fn("stylenet", dec, w.decode_batch, **kw)
    sharded = sharded_beam_fn("stylenet", dec, make_mesh((n_devices, 1),
                              devices=devices), w.decode_batch, **kw)
    with jax.default_matmul_precision("highest"):
        a, b = single(x, 1), sharded(x, 1)
    same = bool(np.array_equal(np.asarray(a.tokens), np.asarray(b.tokens)))
    ended = int(np.sum(np.asarray(a.length) > 2))
    t_one = timed_ms(single, x, 1, reps=3)
    t_dp = timed_ms(sharded, x, 1, reps=3)
    out["decode"] = {"same_tokens": same, "nonempty": ended, "one_ms": t_one,
                     "dp_ms": t_dp}
    log(f"[four-cards] data-parallel beam B={w.decode_batch} at highest: "
        f"tokens identical to one card: {same} ({ended} non-empty "
        f"captions); default precision: {t_one:.1f} ms on one card, "
        f"{t_dp:.1f} ms on {n_devices}")
    if not same:
        raise AssertionError("data-parallel decode tokens differ")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    ap.add_argument("--out", default=None,
                    help="directory for results.json (default: none)")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    dev = phase_device(count)
    card = dev["card"]
    results = {"device": dev}
    # generated corpora, features and checkpoints: a temporary directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            results["four_cards"] = phase_four_cards(work)
        else:
            results["kernel"] = phase_kernel(card)
            results["serving"] = phase_serving(os.path.join(work, "serve"))
            results["training"] = phase_training(os.path.join(work, "train"))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "results.json"), "w") as f:
            json.dump(results, f, indent=1, default=str)
    log(f"[device] card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
