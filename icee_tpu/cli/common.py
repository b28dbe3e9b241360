"""Shared CLI plumbing: configs from flags, feature providers, model builders.

The reference hard-codes user-specific absolute paths as argparse defaults
(``train_multitask.py:577-581``); here defaults are relative and every CLI
shares one flag vocabulary.

Feature sourcing (three ways, first available wins):

1. ``--feature_cache path.npz`` — precomputed ``{image_name: feature}``
   arrays (the fast path: encode each unique image ONCE, reuse
   across epochs — the reference re-runs the frozen ResNet every epoch),
2. ``--image_dir`` + optional ``--resnet_weights`` (torch ``.pth``
   state_dict or ``.npz``) — runs the JAX ResNet-152 backbone,
3. random-but-deterministic per-image features (no weights available —
   offline smoke mode, clearly logged).
"""

from __future__ import annotations

import argparse
import os
import zlib
from typing import Callable, Optional

import numpy as np

from icee_tpu.core.config import (
    AttentionDecoderConfig,
    DecoderConfig,
    EncoderConfig,
    Seq2SeqConfig,
    TrainConfig,
)


def add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--embed_size", type=int, default=300)
    p.add_argument("--hidden_size", type=int, default=512)
    p.add_argument("--factored_size", type=int, default=512)
    p.add_argument("--attention_size", type=int, default=512)
    p.add_argument("--num_layers", type=int, default=1)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--max_seq_length", type=int, default=40)
    p.add_argument("--backbone_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="ResNet conv precision: bfloat16 runs the backbone "
                        "convs in bf16 on the tensor cores (BN stays f32)")


def add_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mode", type=str, default="happy")
    p.add_argument("--num_epochs", type=int, default=120)
    p.add_argument("--caption_batch_size", type=int, default=64)
    p.add_argument("--language_batch_size", type=int, default=96)
    p.add_argument("--lr_caption", type=float, default=2e-4)
    p.add_argument("--lr_language", type=float, default=5e-4)
    p.add_argument("--grad_clip", type=float, default=0.5)
    p.add_argument("--log_step", type=int, default=50)
    p.add_argument("--log_step_emotion", type=int, default=5)
    p.add_argument("--log_path", type=str, default="out.log")
    p.add_argument("--metrics_path", type=str, default=None,
                   help="append-only JSONL metrics file "
                        "(utils/logging.MetricsLogger): one record per "
                        "epoch/track with loss/ppl/top-5/BLEU-4/LR — the "
                        "machine-readable companion to --log_path")
    p.add_argument("--model_path", type=str, default="models/")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunked_ce", choices=["auto", "on", "off"],
                   default="auto",
                   help="chunked training CE (ops/chunked_loss.py, the "
                        "(B,T,V) logits never materialize); auto = the "
                        "platform's default (core/backend.py)")
    p.add_argument("--progress_chunk", type=int, default=0,
                   help="with --device_resident: run each epoch as chunks "
                        "of this many batch rows and write a mid-epoch "
                        "progress checkpoint after every chunk "
                        "(checkpoint/progress.py) — a preempted run "
                        "resumes INSIDE the epoch, bit-identically; "
                        "0 = whole-epoch single dispatch")


def add_data_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--vocab_path", type=str, default="data/flickr8k_id/vocab.pkl")
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--caption_path", type=str,
                   default="data/flickr8k_id/train.txt")
    p.add_argument("--val_caption_path", type=str,
                   default="data/flickr8k_id/val.txt")
    p.add_argument("--happy_path", type=str,
                   default="data/flickr8k_id/happy/train.txt")
    p.add_argument("--val_happy_path", type=str,
                   default="data/flickr8k_id/happy/val.txt")
    p.add_argument("--sad_path", type=str,
                   default="data/flickr8k_id/sad/train.txt")
    p.add_argument("--val_sad_path", type=str,
                   default="data/flickr8k_id/sad/val.txt")
    p.add_argument("--angry_path", type=str,
                   default="data/flickr8k_id/angry/train.txt")
    p.add_argument("--val_angry_path", type=str,
                   default="data/flickr8k_id/angry/val.txt")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--crop_size", type=int, default=224)
    p.add_argument("--feature_cache", type=str, default=None,
                   help="npz of precomputed image features")
    p.add_argument("--resnet_weights", type=str, default=None,
                   help="torch .pth state_dict or .npz for ResNet-152")


def decoder_config(args, vocab_size: int, attention: bool = False):
    cls = AttentionDecoderConfig if attention else DecoderConfig
    return cls(
        vocab_size=vocab_size,
        embed_size=args.embed_size,
        hidden_size=args.hidden_size,
        factored_size=args.factored_size,
        num_layers=args.num_layers,
        dropout=args.dropout,
        max_seq_length=args.max_seq_length,
        **({"attention_size": args.attention_size} if attention else {}),
    )


def train_config(args) -> TrainConfig:
    return TrainConfig(
        mode=args.mode,
        num_epochs=args.num_epochs,
        caption_batch_size=args.caption_batch_size,
        language_batch_size=args.language_batch_size,
        lr_caption=args.lr_caption,
        lr_language=args.lr_language,
        grad_clip=args.grad_clip,
        log_step=args.log_step,
        log_step_emotion=args.log_step_emotion,
        max_caption_len=args.max_seq_length + 2,
        seed=args.seed,
        crop_size=args.crop_size,
        chunked_ce={"auto": None, "on": True, "off": False}[
            getattr(args, "chunked_ce", "auto")],
        progress_chunk=getattr(args, "progress_chunk", 0),
    )


def load_resnet_params(path: Optional[str], conv_dtype: str = "float32"):
    """Backbone weights from torch .pth / .npz, or a random init whose
    residual branches start at zero (features of order one, not 1e4).

    ``conv_dtype="bfloat16"`` casts only the conv kernels (BN stays f32) so
    the backbone convs run in bf16."""
    import jax
    import jax.numpy as jnp
    from icee_tpu.models import resnet

    if path is None:
        params = resnet.init_params(jax.random.PRNGKey(0))
    elif path.endswith(".npz"):
        sd = dict(np.load(path))
        params = resnet.import_torch_state_dict(sd)
    else:
        import torch

        sd = torch.load(path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        # strip an "resnet." wrapper prefix if present (EncoderCNN pickles)
        sd = {k.removeprefix("resnet."): v for k, v in sd.items()}
        params = resnet.import_torch_state_dict(sd)
    if conv_dtype != "float32":
        params = resnet.cast_conv_weights(params, jnp.dtype(conv_dtype))
    return params


def make_feature_provider(
    args, spatial: bool = False, grid: int = 14, augment: bool = False,
    resize_size: int = 336, seed: int = 0,
) -> Callable[[str], np.ndarray]:
    """image name -> encoder feature array (see module docstring).

    ``augment=True`` reproduces the reference TRAINING transform
    (Resize(336) -> RandomCrop(224) -> RandomHorizontalFlip,
    ``train_multitask.py:63-69``): the decoded 336px image is cached, the
    random crop/flip + backbone run per call with a fresh PRNG, so every
    epoch sees new crops.  ``augment=False`` is the eval transform
    (Resize(crop) direct) with features memoized per image — the fast path.
    """
    if args.feature_cache and os.path.exists(args.feature_cache):
        cache = dict(np.load(args.feature_cache))
        return lambda name: cache[name]

    if args.image_dir:
        import jax
        import jax.numpy as jnp
        from icee_tpu.data.transforms import (
            host_decode_resize,
            normalize,
            train_augment,
        )
        from icee_tpu.models import resnet

        backbone = load_resnet_params(
            args.resnet_weights, getattr(args, "backbone_dtype", "float32"))
        if args.resnet_weights is None:
            print("WARNING: no --resnet_weights given; backbone is randomly "
                  "initialized (offline smoke mode)")

        def backbone_features(x):
            if spatial:
                out, _ = resnet.spatial_features(backbone, x, grid=grid)
                return out[0].reshape(grid * grid, -1)
            out, _ = resnet.global_features(backbone, x)
            return out[0]

        if augment:
            from collections import OrderedDict

            @jax.jit
            def run_aug(img, key):
                x = train_augment(img[None], key, crop_size=args.crop_size)
                return backbone_features(x)

            # bounded LRU of decoded 336px images (~340KB each; 4096 ≈ 1.4GB)
            # — an unbounded cache OOMs the host on large corpora
            img_memo: "OrderedDict" = OrderedDict()
            max_cached = 4096
            key_holder = {"key": jax.random.PRNGKey(seed)}

            def provider(name):
                if name in img_memo:
                    img_memo.move_to_end(name)
                else:
                    img_memo[name] = host_decode_resize(
                        os.path.join(args.image_dir, name), resize_size)
                    if len(img_memo) > max_cached:
                        img_memo.popitem(last=False)
                key_holder["key"], k = jax.random.split(key_holder["key"])
                return np.asarray(run_aug(jnp.asarray(img_memo[name]), k))

            return provider

        @jax.jit
        def run(img):
            return backbone_features(normalize(img[None]))

        memo = {}

        def provider(name):
            if name not in memo:
                img = host_decode_resize(
                    os.path.join(args.image_dir, name), args.crop_size)
                memo[name] = np.asarray(run(jnp.asarray(img)))
            return memo[name]

        return provider

    print("WARNING: no images or feature cache; using deterministic random "
          "features (offline smoke mode)")
    feat_dim = 2048

    def provider(name):
        seed = zlib.crc32(name.encode()) & 0xFFFFFFFF
        rng = np.random.default_rng(seed)
        if spatial:
            return rng.standard_normal((grid * grid, feat_dim)).astype(np.float32)
        return rng.standard_normal((feat_dim,)).astype(np.float32)

    return provider
