"""``python -m icee_tpu.cli.caption_batch`` — throughput batch captioning.

Production counterpart of the reference's one-image ``sample.py`` / per-
request ``app/backend/sample.py:52-97`` flow: caption EVERY image in a
directory (or a feature cache) in one run, beam-decoding in large fixed
batches (``decode/fast.py``), and emit one JSON object
``{image: caption}``.

The reference has no batch-inference tool — captioning N images means N
process launches, each reloading the checkpoint (``sample.py:37-47``).
Here the checkpoint loads once, the backbone runs batched, and the decode
is the benchmark's batched path.  Serving semantics by default (image
feature fed at beam step 1, ``app/backend/model.py:414-417``); pass
``--research_semantics`` for the ``stylenet/model.py:224-227`` behavior.
"""

import argparse
import json
import os
import sys

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def caption_batch(dec_params, head, cfg, vocab, names, provider, mode_idx,
                  batch_size=64, k=5, attention=False, feed_feature=True,
                  mesh=None):
    """-> dict image name -> detokenized caption (serving detok contract:
    strip specials, drop trailing ``<unk>``, ``app/backend/sample.py:82-96``).

    ``mesh``: a ``("data", "model")`` mesh decodes each batch data-parallel
    via ``fast.sharded_beam_fn`` (params replicated, images split over the
    data axis, no collectives)."""
    import jax.numpy as jnp

    from icee_tpu.decode import fast
    from icee_tpu.models import encoder as enc_mod

    style = jnp.asarray(mode_idx)
    batch_size = min(batch_size, max(1, len(names)))
    if mesh is not None:
        from icee_tpu.parallel.mesh import DATA_AXIS

        n_data = mesh.shape[DATA_AXIS]
        batch_size = max(n_data, batch_size - batch_size % n_data)
    family = "stylenet_att" if attention else "stylenet"
    kw = dict(batch=batch_size, k=k, max_seq_length=cfg.max_seq_length,
              vocab_size=cfg.vocab_size, start_token=vocab.start,
              end_token=vocab.end, feed_feature=feed_feature)
    if mesh is not None:
        # data-parallel beam decode: images split over the mesh's data axis
        # (params replicated, no collectives)
        beam = fast.sharded_beam_fn(family, dec_params, mesh, **kw)
    else:
        beam = fast.beam_fn(family, dec_params, **kw)

    out = {}
    for i in range(0, len(names), batch_size):
        chunk = names[i : i + batch_size]
        pooled = np.stack([provider(name) for name in chunk])
        if attention:
            feats = jnp.asarray(pooled)         # (n, P, 2048) spatial grids
        else:
            feats, _ = enc_mod.encode_global_from_pooled(
                head, jnp.asarray(pooled), train=False)
        n = feats.shape[0]
        if n < batch_size:                      # one compiled shape
            feats = jnp.concatenate(
                [feats, jnp.zeros((batch_size - n,) + feats.shape[1:],
                                  feats.dtype)])
        res = beam(feats, style)
        toks = np.asarray(res.tokens)
        lens = np.asarray(res.length)
        for b, name in enumerate(chunk):
            words = vocab.decode(toks[b, : int(lens[b])])
            while words and words[-1] == "<unk>":
                words.pop()
            out[name] = " ".join(words)
    return out


def main(args) -> None:
    from icee_tpu.core.backend import start_entry_point

    start_entry_point()
    import jax

    from icee_tpu.cli import common
    from icee_tpu.core.config import EncoderConfig, mode_id
    from icee_tpu.data.vocab import load_vocab
    from icee_tpu.models import encoder as enc_mod
    from icee_tpu.models import factored_lstm as fl

    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab), attention=args.attention)

    if args.feature_cache and not os.path.exists(args.feature_cache):
        raise SystemExit(f"feature cache not found: {args.feature_cache}")
    cache_files = (set(np.load(args.feature_cache).files)
                   if args.feature_cache else None)
    if args.image_dir:
        names = sorted(
            f for f in os.listdir(args.image_dir)
            if f.lower().endswith(IMAGE_EXTS))
        if cache_files is not None:
            # the provider serves from the cache, so a directory image
            # missing there would KeyError mid-run; validate up front
            missing = [n for n in names if n not in cache_files]
            if missing:
                raise SystemExit(
                    f"{len(missing)} image(s) in --image_dir are absent "
                    f"from --feature_cache (first: {missing[0]}); "
                    "re-run precompute_features or drop --feature_cache")
    elif cache_files is not None:
        names = sorted(cache_files)
    else:
        raise SystemExit("need --image_dir or --feature_cache")
    if not names:
        raise SystemExit("no images found")

    provider = common.make_feature_provider(args, spatial=args.attention)

    if args.checkpoint_path:
        from icee_tpu.checkpoint.ckpt import load_params

        params = load_params(args.checkpoint_path)
        dec, head = params["decoder"], params["head"]
    else:
        print("WARNING: no --checkpoint_path; random weights (smoke mode)",
              file=sys.stderr)
        from icee_tpu.models import attention as att_mod

        if args.attention:
            dec = att_mod.init_factored_att_params(jax.random.PRNGKey(0), cfg)
        else:
            dec = fl.init_params(jax.random.PRNGKey(0), cfg)
        head = enc_mod.init_head_params(
            jax.random.PRNGKey(1), EncoderConfig(embed_size=cfg.embed_size))

    mesh = None
    if args.data_parallel and len(jax.devices()) > 1:
        from icee_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()           # all devices on the data axis
    elif args.data_parallel:
        print("WARNING: --data_parallel needs >1 device; "
              "decoding single-device", file=sys.stderr)

    captions = caption_batch(
        dec, head, cfg, vocab, names, provider, mode_id(args.mode),
        batch_size=args.batch_size, k=args.beam_size,
        attention=args.attention, feed_feature=not args.research_semantics,
        mesh=mesh)

    text = json.dumps(captions, ensure_ascii=False, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {len(captions)} captions to {args.out}")
    else:
        print(text)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--attention", action="store_true",
                        help="use the attention decoder family")
    parser.add_argument("--data_parallel", action="store_true",
                        help="decode data-parallel over all devices "
                             "(jax.sharding.Mesh + shard_map; both families)")
    parser.add_argument("--research_semantics", action="store_true",
                        help="ignore the image feature in the beam "
                             "(stylenet/model.py:224-227) instead of the "
                             "serving step-1 feed")
    parser.add_argument("--mode", type=str, default="factual")
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--out", type=str, default=None,
                        help="output JSON path (default: stdout)")
    parser.add_argument("--vocab_path", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--beam_size", type=int, default=5)
    parser.add_argument("--feature_cache", type=str, default=None)
    parser.add_argument("--resnet_weights", type=str, default=None)
    parser.add_argument("--crop_size", type=int, default=224)
    from icee_tpu.cli.common import add_model_flags

    add_model_flags(parser)
    main(parser.parse_args())
