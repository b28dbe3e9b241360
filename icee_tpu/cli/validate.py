"""``python -m icee_tpu.cli.validate`` — standalone validation pass
(reference ``stylenet/validate.py``, SURVEY E2): teacher-forced loss + top-5
accuracy over a split, plus a batched GREEDY sample per image scored with
corpus BLEU-4 against all references."""

import argparse

import numpy as np


def main(args) -> None:
    from icee_tpu.core.backend import start_entry_point

    start_entry_point()
    import jax
    import jax.numpy as jnp

    from icee_tpu.cli import common
    from icee_tpu.core.config import EncoderConfig, mode_id
    from icee_tpu.data.captions import load_caption_dataset
    from icee_tpu.data.pipeline import caption_dataset_loader
    from icee_tpu.data.vocab import load_vocab
    from icee_tpu.decode.greedy import greedy_decode
    from icee_tpu.evaluation.bleu import corpus_bleu
    from icee_tpu.evaluation.metrics import (AverageMeter,
                                             masked_cross_entropy,
                                             masked_top_k_accuracy, perplexity)
    from icee_tpu.models import encoder as enc_mod
    from icee_tpu.models import factored_lstm as fl
    from icee_tpu.train.loops import strip_specials

    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab))
    ecfg = EncoderConfig(embed_size=cfg.embed_size)
    provider = common.make_feature_provider(args)
    ds = load_caption_dataset(args.caption_path, vocab)
    loader = caption_dataset_loader(ds, batch_size=args.batch_size,
                                    max_len=cfg.max_seq_length + 2,
                                    image_provider=provider, shuffle=False)

    if args.checkpoint_path:
        from icee_tpu.checkpoint.ckpt import load_params

        params = load_params(args.checkpoint_path)
        dec, head = params["decoder"], params["head"]
    else:
        print("WARNING: random weights (smoke mode)")
        dec = fl.init_params(jax.random.PRNGKey(0), cfg)
        head = enc_mod.init_head_params(jax.random.PRNGKey(1), ecfg)

    style = jnp.asarray(mode_id(args.mode))

    @jax.jit
    def val_batch(pooled, captions, lengths, smask):
        feats, _ = enc_mod.encode_global_from_pooled(head, pooled, False)
        logits = fl.forward(dec, cfg, captions, feats, style,
                            teacher_forcing_ratio=0.0, train=False)
        loss = masked_cross_entropy(logits, captions, lengths, smask)
        top5 = masked_top_k_accuracy(logits, captions, lengths, 5, smask)
        ids = greedy_decode(
            embed_fn=lambda t: fl.embed(dec, t),
            step_fn=lambda x, s: fl.decode_step(dec, x, s, style),
            init_state=fl.initial_state(pooled.shape[0], cfg),
            first_input=feats, max_steps=cfg.max_seq_length)
        return loss, top5, ids

    losses, top5s = AverageMeter(), AverageMeter()
    references, hypotheses = [], []
    end = vocab.end
    for batch in loader:
        loss, top5, ids = val_batch(
            jnp.asarray(batch.images), jnp.asarray(batch.captions),
            jnp.asarray(batch.lengths), jnp.asarray(batch.sample_mask))
        n = int(batch.lengths.sum())
        losses.update(float(loss), n)
        top5s.update(float(top5), n)
        ids = np.asarray(ids)
        for b in range(batch.batch_size):
            if not batch.sample_mask[b]:
                continue
            references.append([strip_specials(r, vocab.start, end)
                               for r in batch.references[b]])
            hyp = []
            for w in ids[b].tolist():
                if w == end:
                    break
                hyp.append(w)
            hypotheses.append(hyp)
    bleu4 = corpus_bleu(references, hypotheses)
    print(f"Val Loss {losses.avg:.4f} | Perplexity "
          f"{perplexity(losses.avg):.4f} | Top-5 {top5s.avg:.3f} | "
          f"BLEU-4 {bleu4}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--mode", type=str, default="factual")
    parser.add_argument("--caption_path", type=str, required=True)
    parser.add_argument("--vocab_path", type=str, required=True)
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--feature_cache", type=str, default=None)
    parser.add_argument("--resnet_weights", type=str, default=None)
    parser.add_argument("--crop_size", type=int, default=224)
    parser.add_argument("--batch_size", type=int, default=64)
    from icee_tpu.cli.common import add_model_flags

    add_model_flags(parser)
    main(parser.parse_args())
