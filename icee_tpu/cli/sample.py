"""``python -m icee_tpu.cli.sample`` — single-image captioning CLI
(reference ``stylenet/sample.py:24-71`` / ``nic/sample.py``).

Loads a vocab + decoder checkpoint (ours, or a reference torch
state_dict via the import shims), encodes the image, beam-decodes in
``--mode``, and prints the detokenized caption.
"""

import argparse

import numpy as np


def caption_image(dec_params, cfg, vocab, feature, mode_idx, k=5,
                  feed_feature=True):
    import jax.numpy as jnp

    from icee_tpu.decode.beam import beam_search
    from icee_tpu.models import factored_lstm as fl

    feat = jnp.tile(jnp.asarray(feature)[None, :], (k, 1))
    res = beam_search(
        embed_fn=lambda t: fl.embed(dec_params, t),
        step_fn=lambda x, s: fl.decode_step(dec_params, x, s,
                                            jnp.asarray(mode_idx)),
        init_model_state=fl.initial_state(k, cfg),
        start_token=vocab.start, end_token=vocab.end, k=k,
        max_seq_length=cfg.max_seq_length, vocab_size=cfg.vocab_size,
        first_input=feat if feed_feature else None,
    )
    ids = np.asarray(res.tokens)[: int(res.length)]
    words = []
    for wid in ids:
        word = vocab.idx2word[int(wid)]
        if word == "<end>":
            break
        words.append(word)
    return " ".join(w for w in words if w != "<start>")


def main(args) -> None:
    from icee_tpu.core.backend import start_entry_point

    start_entry_point()
    import jax

    from icee_tpu.cli import common
    from icee_tpu.core.config import mode_id
    from icee_tpu.data.vocab import load_vocab
    from icee_tpu.models import factored_lstm as fl

    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab))

    if args.decoder_path and args.decoder_path.endswith((".pth", ".tar",
                                                         ".ckpt")):
        import torch

        from icee_tpu.checkpoint.torch_import import (
            import_factored_decoder_state_dict)

        sd = torch.load(args.decoder_path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        dec = import_factored_decoder_state_dict(sd)
    elif args.decoder_path:
        from icee_tpu.checkpoint.ckpt import load_params

        dec = load_params(args.decoder_path)["decoder"]
    else:
        print("WARNING: no --decoder_path; random decoder (smoke mode)")
        dec = fl.init_params(jax.random.PRNGKey(0), cfg)

    import os

    import jax.numpy as jnp

    from icee_tpu.core.config import EncoderConfig
    from icee_tpu.models import encoder as enc_mod

    args.image_dir = args.image_dir or os.path.dirname(args.image) or "."
    provider = common.make_feature_provider(args)
    pooled = provider(os.path.basename(args.image))

    # encoder head: trained torch EncoderCNN state_dict, or fresh (smoke)
    ecfg = EncoderConfig(embed_size=cfg.embed_size)
    if args.encoder_path:
        import torch

        from icee_tpu.checkpoint.torch_import import (
            import_encoder_head_state_dict)

        sd = torch.load(args.encoder_path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        head = import_encoder_head_state_dict(sd)
    else:
        head = enc_mod.init_head_params(jax.random.PRNGKey(1), ecfg)
    feature, _ = enc_mod.encode_global_from_pooled(
        head, jnp.asarray(pooled)[None, :], train=False)
    print(caption_image(dec, cfg, vocab, np.asarray(feature)[0],
                        mode_id(args.mode)))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--image", type=str, required=True,
                        help="input image for generating caption")
    parser.add_argument("--encoder_path", type=str, default=None,
                        help="path for trained encoder")
    parser.add_argument("--decoder_path", type=str, default=None,
                        help="path for trained decoder")
    parser.add_argument("--vocab_path", type=str, default="data/vocab.pkl")
    parser.add_argument("--mode", type=str, default="factual")
    from icee_tpu.cli.common import add_data_flags, add_model_flags

    add_model_flags(parser)
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--feature_cache", type=str, default=None)
    parser.add_argument("--resnet_weights", type=str, default=None)
    parser.add_argument("--crop_size", type=int, default=224)
    main(parser.parse_args())
