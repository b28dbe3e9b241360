"""``python -m icee_tpu.cli.inspect_ckpt`` — checkpoint inspector (reference
``stylenet/importer.py:1-33``, SURVEY X2): load a checkpoint and print each
parameter leaf alongside a fresh-init module's, as a manual sanity check
that restoration actually changed the weights."""

import argparse

import numpy as np


def _summ(x) -> str:
    a = np.asarray(x)
    return (f"shape={tuple(a.shape)} mean={a.mean():+.5f} "
            f"std={a.std():.5f} |max|={np.abs(a).max():.5f}")


def main(args) -> None:
    from icee_tpu.core.backend import start_entry_point

    start_entry_point()
    import jax

    from icee_tpu.checkpoint.ckpt import load_checkpoint
    from icee_tpu.cli import common
    from icee_tpu.core.config import EncoderConfig
    from icee_tpu.data.vocab import load_vocab
    from icee_tpu.models import encoder as enc_mod
    from icee_tpu.models import factored_lstm as fl

    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab))
    fresh = fl.init_params(jax.random.PRNGKey(0), cfg)
    head = enc_mod.init_head_params(
        jax.random.PRNGKey(1), EncoderConfig(embed_size=cfg.embed_size))
    from icee_tpu.checkpoint.ckpt import load_params

    dec = load_params(args.checkpoint_path)["decoder"]
    print(f"{'param':12s} {'loaded':60s} {'fresh init':60s} same?")
    for name in sorted(fresh):
        same = np.allclose(np.asarray(dec[name]), np.asarray(fresh[name]))
        print(f"{name:12s} {_summ(dec[name]):60s} {_summ(fresh[name]):60s} "
              f"{same}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--vocab_path", type=str, required=True)
    from icee_tpu.cli.common import add_model_flags

    add_model_flags(parser)
    main(parser.parse_args())
