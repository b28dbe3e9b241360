"""``python -m icee_tpu.cli.export`` — checkpoint exporter (reference
``stylenet/exporter.py:17-40``, SURVEY X1): wrap bare per-epoch parameter
checkpoints (or reference torch ``state_dict`` files) into the full
checkpoint format with fresh optimizer state and BLEU bookkeeping, so they
can resume training or feed the serving registry."""

import argparse


def main(args) -> None:
    from icee_tpu.core.backend import start_entry_point

    start_entry_point()
    import jax

    from icee_tpu.checkpoint.ckpt import (CheckpointState, load_checkpoint,
                                          save_checkpoint)
    from icee_tpu.cli import common
    from icee_tpu.core.config import EncoderConfig, TrainConfig
    from icee_tpu.data.vocab import load_vocab
    from icee_tpu.models import encoder as enc_mod
    from icee_tpu.models import factored_lstm as fl
    from icee_tpu.train import optim

    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab))
    ecfg = EncoderConfig(embed_size=cfg.embed_size)
    tcfg = TrainConfig()

    if args.decoder_path.endswith((".pth", ".tar", ".ckpt")):
        import torch

        from icee_tpu.checkpoint.torch_import import (
            import_encoder_head_state_dict,
            import_factored_decoder_state_dict,
        )

        dec_sd = torch.load(args.decoder_path, map_location="cpu")
        if hasattr(dec_sd, "state_dict"):
            dec_sd = dec_sd.state_dict()
        dec = import_factored_decoder_state_dict(dec_sd)
        if args.encoder_path:
            enc_sd = torch.load(args.encoder_path, map_location="cpu")
            if hasattr(enc_sd, "state_dict"):
                enc_sd = enc_sd.state_dict()
            head = import_encoder_head_state_dict(
                {k: v for k, v in enc_sd.items()
                 if not k.startswith("resnet.")})
        else:
            head = enc_mod.init_head_params(jax.random.PRNGKey(1), ecfg)
    else:
        from icee_tpu.checkpoint.ckpt import load_params

        params = load_params(args.decoder_path)
        dec, head = params["decoder"], params["head"]

    optimizer = optim.make_adam(tcfg.lr_caption, tcfg)
    lang = optim.make_adam(tcfg.lr_language, tcfg)
    state = CheckpointState(
        epoch=args.epoch,
        epochs_since_improvement={"factual": 0, "emotion": 0},
        best_bleu4={"factual": args.bleu4, "emotion": 0.0},
        params={"decoder": dec, "head": head},
        opt_states={"optimizer": optimizer.init((dec, head)),
                    "lang_optimizer": lang.init(dec)},
    )
    path = save_checkpoint(args.out_dir, args.data_name, args.mode.upper()[:3],
                           state, is_best=args.best)
    print(f"exported full checkpoint to {path}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--decoder_path", type=str, required=True)
    parser.add_argument("--encoder_path", type=str, default=None)
    parser.add_argument("--vocab_path", type=str, required=True)
    parser.add_argument("--out_dir", type=str, default="models/")
    parser.add_argument("--data_name", type=str, default="flickr8k_id")
    parser.add_argument("--mode", type=str, default="factual")
    parser.add_argument("--epoch", type=int, default=0)
    parser.add_argument("--bleu4", type=float, default=0.0)
    parser.add_argument("--best", action="store_true")
    from icee_tpu.cli.common import add_model_flags

    add_model_flags(parser)
    main(parser.parse_args())
