"""``python -m icee_tpu.cli.evaluate`` — held-out-test BLEU evaluator
(reference ``stylenet/evaluator.py:59-139``): beam-decode every test image in
``--mode``, print ref/pred pairs, report corpus BLEU-1..4 with cumulative
weights.

Difference: the reference decodes one image at a time in Python; here the
whole test set beam-decodes in jitted batches (``decode/fast.py``).

Parity note: like the reference, BLEU here is computed over raw id sequences
INCLUDING ``<start>``/``<end>`` (``evaluator.py:74-104`` — unlike the
trainers' validation BLEU which strips them).
"""

import argparse
import sys

import numpy as np


def evaluate(dec_params, head, cfg, vocab, dataset, provider, mode_idx,
             batch_size=64, k=5, print_pairs=True, attention=False,
             feed_feature=False, mesh=None):
    import jax.numpy as jnp

    from icee_tpu.models import encoder as enc_mod
    from icee_tpu.evaluation.bleu import bleu_1_to_4

    style = jnp.asarray(mode_idx)

    # Batched beam decode (decode/fast.py).  Attention targets the
    # reference evaluator's DecoderFactoredLSTMAtt (evaluator.py:33-56); the
    # default non-attention
    # path reproduces the research sample() semantics (feature never fed,
    # stylenet/model.py:224-227) unless --feed_feature opts into the
    # serving semantics (app/backend/model.py:414-417).
    from icee_tpu.decode import fast

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

    # one beam decode per unique image (evaluator decodes per test line; lines
    # repeat images with different refs — the reference decodes per line, so
    # mirror that)
    references, hypotheses = [], []
    for i in range(0, len(dataset), batch_size):
        chunk = dataset[i : i + batch_size]
        pooled = np.stack([provider(ex.image) for ex in chunk])
        if attention:
            feats = jnp.asarray(pooled)  # (n, P, 2048) spatial grids
        else:
            feats, _ = enc_mod.encode_global_from_pooled(
                head, jnp.asarray(pooled), train=False)
        # pad chunk to batch_size for a single compiled shape
        n = feats.shape[0]
        if n < batch_size:
            feats = jnp.concatenate(
                [feats, jnp.zeros((batch_size - n,) + feats.shape[1:],
                                  feats.dtype)])
        res = beam(feats, style)
        toks = np.asarray(res.tokens)
        lens = np.asarray(res.length)
        for b, ex in enumerate(chunk):
            refs = [list(map(int, r)) for r in ex.all_caption_ids]
            hyp = toks[b, : lens[b]].tolist()
            references.append(refs)
            hypotheses.append(hyp)
            if print_pairs:
                print("ref", " ".join(vocab.idx2word[w] for w in refs[0]))
                print("pred", " ".join(vocab.idx2word[w] for w in hyp))
    return bleu_1_to_4(references, hypotheses)


def main(args) -> None:
    from icee_tpu.core.backend import start_entry_point

    start_entry_point()
    import jax

    from icee_tpu.cli import common
    from icee_tpu.core.config import EncoderConfig, mode_id
    from icee_tpu.data.captions import load_caption_dataset
    from icee_tpu.data.vocab import load_vocab
    from icee_tpu.models import encoder as enc_mod
    from icee_tpu.models import factored_lstm as fl

    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab), attention=args.attention)
    dataset = load_caption_dataset(args.test_path, vocab)
    provider = common.make_feature_provider(args, spatial=args.attention)

    if args.checkpoint_path:
        from icee_tpu.checkpoint.ckpt import load_params

        params = load_params(args.checkpoint_path)
        dec, head = params["decoder"], params["head"]
    else:
        print("WARNING: no --checkpoint_path; random weights (smoke mode)")
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

        mesh = make_mesh()
    elif args.data_parallel:
        print("WARNING: --data_parallel needs >1 device; "
              "decoding single-device", file=sys.stderr)

    b1, b2, b3, b4 = evaluate(dec, head, cfg, vocab, dataset, provider,
                              mode_id(args.mode), batch_size=args.batch_size,
                              attention=args.attention,
                              feed_feature=args.feed_feature, mesh=mesh)
    print("BLEU-1", b1)
    print("BLEU-2", b2)
    print("BLEU-3", b3)
    print("BLEU-4", b4)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--attention", action="store_true",
                        help="evaluate the attention decoder (reference "
                             "evaluator default)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="beam-decode data-parallel over all devices "
                             "(both families; mega kernel per shard)")
    parser.add_argument("--feed_feature", action="store_true",
                        help="feed the image feature at beam step 1 (serving "
                             "semantics) instead of the reference research "
                             "sample() that ignores it")
    parser.add_argument("--mode", type=str, default="factual")
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--test_path", type=str, required=True)
    parser.add_argument("--vocab_path", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--feature_cache", type=str, default=None)
    parser.add_argument("--resnet_weights", type=str, default=None)
    parser.add_argument("--crop_size", type=int, default=224)
    from icee_tpu.cli.common import add_model_flags

    add_model_flags(parser)
    main(parser.parse_args())
