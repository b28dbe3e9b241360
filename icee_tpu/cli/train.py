"""``python -m icee_tpu.cli.train`` — unified training CLI for every regime.

One entry point replaces the reference's per-regime scripts, selected by
``--trainer`` (flags otherwise mirror ``train_multitask.py:560-634``):

- ``multitask``      -> T2 (``stylenet/train_multitask.py``) / NIC copy
- ``multitask_att``  -> T3 (``train_multitask_att.py``)
- ``transfer_fac``   -> T4 stage-1 factual pretraining
- ``transfer``       -> T5 stage-2 style fine-tune (masked optimizer)
- ``paper``          -> T1 StyleNet-paper regime (text-only style corpora)
- ``seq2seq``        -> T6 (``seq2seq/train.py``)

``--family {stylenet,nic}`` picks the factored vs plain decoder.
"""

import argparse


def main(args) -> None:
    from icee_tpu.core.backend import start_entry_point

    start_entry_point()
    import jax

    from icee_tpu.cli import common
    from icee_tpu.core.config import EncoderConfig, Seq2SeqConfig
    from icee_tpu.data.captions import (
        load_caption_dataset,
        load_styled_caption_dataset,
    )
    from icee_tpu.data.pipeline import caption_dataset_loader
    from icee_tpu.data.vocab import load_vocab
    from icee_tpu.models import attention as att_mod
    from icee_tpu.models import encoder as enc_mod
    from icee_tpu.models import factored_lstm as fl
    from icee_tpu.models import lstm as nic_mod
    from icee_tpu.models import seq2seq as s2s
    from icee_tpu.train.loops import (
        MultitaskTrainer,
        PaperRegimeTrainer,
        Seq2SeqTrainer,
        TransferTrainer,
    )

    vocab = load_vocab(args.vocab_path)
    attention = args.trainer.endswith("_att") or args.attention
    cfg = common.decoder_config(args, len(vocab), attention=attention)
    tcfg = common.train_config(args)
    ecfg = EncoderConfig(embed_size=args.embed_size)
    # training uses the reference augmentation regime (random crop/flip per
    # epoch); validation uses the deterministic eval transform with feature
    # memoization.  --no_augment opts into the cached fast path for training
    # too (constant eval-mode features, SURVEY §7's free-win mode).
    provider_eval = common.make_feature_provider(args, spatial=attention)
    if args.no_augment or args.feature_cache:
        provider_train = provider_eval
    else:
        provider_train = common.make_feature_provider(
            args, spatial=attention, augment=True, seed=args.seed)

    emo_paths = {"happy": (args.happy_path, args.val_happy_path),
                 "sad": (args.sad_path, args.val_sad_path),
                 "angry": (args.angry_path, args.val_angry_path)}

    if args.device_resident and not (args.no_augment or args.feature_cache):
        raise SystemExit(
            "--device_resident pins one feature per image on device, which "
            "requires deterministic features: pass --no_augment or "
            "--feature_cache (per-epoch crop/flip augmentation would be "
            "frozen at its first draw)")

    def loader(path, bs, train=True):
        ds = load_caption_dataset(path, vocab)
        if args.device_resident:
            # whole-epoch device-resident training/validation: the split is
            # pinned in device memory and each epoch is ONE jitted lax.scan
            # dispatch (data/device.py — the answer to per-batch dispatch
            # cost; the senticap family's device_dataset analogue).
            from icee_tpu.data import device as device_data
            import numpy as np

            if not ds:
                raise SystemExit(f"empty caption set: {path}")
            feat_shape = np.asarray(provider_eval(ds[0].image)).shape
            n_unique = len({e.image for e in ds})
            budget = (int(args.device_budget_gb * (1 << 30))
                      if args.device_budget_gb is not None
                      else device_data.default_budget_bytes())
            fdt = None
            fdt_bytes = 4
            if args.feature_dtype == "bfloat16":
                fdt = jax.numpy.bfloat16
                fdt_bytes = 2
            plan = device_data.pin_plan(n_unique, feat_shape,
                                        budget_bytes=budget,
                                        bytes_per_feature=fdt_bytes)
            # every captioner trainer inherits MultitaskTrainer's
            # per-batch/streamed tiers; only Seq2SeqTrainer is a separate
            # class without them (its features are tiny global vectors,
            # so the scan copy is harmless there)
            tiered_ok = args.trainer != "seq2seq"
            if plan == "per_batch" and not tiered_ok:
                plan = "epoch"
            if plan != "stream":
                if plan == "per_batch":
                    print(f"NOTE: {path} features fit the budget once but "
                          "not twice (the whole-epoch program copies the "
                          "pinned array); using per-batch dispatches")
                return device_data.from_examples(
                    ds, batch_size=bs, max_len=tcfg.max_caption_len,
                    image_provider=provider_eval, shuffle=train,
                    seed=args.seed, mesh=mesh,
                    per_batch=(plan == "per_batch"), feature_dtype=fdt)
            if tiered_ok:
                # oversized split (e.g. full-Flickr8k spatial features):
                # stream fixed-capacity feature chunks instead of paying the
                # per-batch host dispatch floor (data/device.py)
                print(f"NOTE: {path} features exceed the device-resident "
                      "budget; streaming per-chunk feature buffers "
                      f"({budget / (1 << 30):g} GiB, double-buffered)")
                return device_data.from_examples_streamed(
                    ds, batch_size=bs, max_len=tcfg.max_caption_len,
                    image_provider=provider_eval, shuffle=train,
                    seed=args.seed, mesh=mesh, budget_bytes=budget,
                    feature_dtype=fdt)
            print(f"WARNING: {path} features exceed the device-resident "
                  "budget; falling back to the host loader")
        return caption_dataset_loader(
            ds, batch_size=bs, max_len=tcfg.max_caption_len,
            image_provider=provider_train if train else provider_eval,
            shuffle=train, seed=args.seed)

    family = "factored" if args.family == "stylenet" else "nic"
    if attention:
        family += "_att"

    # multi-device training (SURVEY §2.5 DP row): a ("data", "model") mesh
    # over all visible devices; the trainers place params/batches and the
    # SAME jitted steps run data(+tensor)-parallel via GSPMD.  Multi-host
    # runs additionally call parallel.mesh.init_distributed first (each
    # host then feeds its shard of every batch).
    mesh = None
    if args.data_parallel:
        from icee_tpu.parallel.mesh import init_distributed, make_mesh
        from icee_tpu.parallel.train import dp_tp_shape

        init_distributed(args.coordinator_address, args.num_processes,
                         args.process_id)
        n = len(jax.devices())
        if n == 1:
            print("WARNING: --data_parallel with a single device; "
                  "training single-device")
        else:
            shape = dp_tp_shape(n, tp=args.tensor_parallel) \
                if args.tensor_parallel > 1 else (n, 1)
            mesh = make_mesh(shape)
            for name in ("caption_batch_size", "language_batch_size"):
                bs = getattr(tcfg, name)
                if bs % shape[0]:
                    raise SystemExit(
                        f"--{name} {bs} must divide by the data-axis size "
                        f"{shape[0]} for even batch sharding")

    key = jax.random.PRNGKey(args.seed)
    if family == "factored":
        dec = fl.init_params(key, cfg)
    elif family == "nic":
        dec = nic_mod.init_params(key, cfg)
    elif family == "factored_att":
        dec = att_mod.init_factored_att_params(key, cfg)
    else:
        dec = att_mod.init_rnn_att_params(key, cfg)
    head = None if attention else enc_mod.init_head_params(
        jax.random.PRNGKey(args.seed + 1), ecfg)

    common_kw = dict(
        cfg=cfg, tcfg=tcfg, vocab=vocab, dec_params=dec, head_params=head,
        family=family, log_path=args.log_path, model_dir=args.model_path,
        data_name=args.data_name, metrics_path=args.metrics_path, mesh=mesh)

    if args.trainer in ("multitask", "multitask_att"):
        trainer = MultitaskTrainer(**common_kw)
        if args.checkpoint_path:
            # full resume: params + both optimizers + plateau counters
            trainer.restore(args.checkpoint_path)
            print(f"start_epoch {trainer.start_epoch}")
        emo_train, emo_val = emo_paths[args.mode]
        trainer.train(
            loader(args.caption_path, tcfg.caption_batch_size),
            loader(args.val_caption_path, tcfg.caption_batch_size,
                   train=False),
            loader(emo_train, tcfg.language_batch_size),
            loader(emo_val, tcfg.language_batch_size, train=False))
    elif args.trainer == "transfer_fac":
        trainer = MultitaskTrainer(**common_kw)
        trainer.train_factual_only(
            loader(args.caption_path, tcfg.caption_batch_size),
            loader(args.val_caption_path, tcfg.caption_batch_size,
                   train=False))
    elif args.trainer == "transfer":
        trainer = TransferTrainer(**common_kw)
        if args.checkpoint_path:
            # transfer loads the factual stage's PARAMETERS and builds fresh
            # optimizers over the style group (train_transfer.py:94-115)
            from icee_tpu.checkpoint.ckpt import load_params

            params = load_params(args.checkpoint_path)
            trainer.dec = params["decoder"]
            trainer.head = params["head"]
        emo_train, emo_val = emo_paths[args.mode]
        trainer.train_transfer(
            loader(emo_train, tcfg.language_batch_size),
            loader(emo_val, tcfg.language_batch_size, train=False))
    elif args.trainer == "paper":
        trainer = PaperRegimeTrainer(**common_kw)

        from icee_tpu.data.pipeline import styled_caption_loader

        def style_loader(path):
            ds = load_styled_caption_dataset(path, vocab)
            if args.device_resident:
                # text-only corpora always fit (ids are (N, T) int32)
                from icee_tpu.data import device as device_data

                return device_data.from_styled(
                    ds, batch_size=tcfg.language_batch_size,
                    max_len=tcfg.max_caption_len, seed=args.seed, mesh=mesh)
            return styled_caption_loader(
                ds, batch_size=tcfg.language_batch_size,
                max_len=tcfg.max_caption_len, seed=args.seed)

        trainer.train(
            loader(args.caption_path, tcfg.caption_batch_size),
            {emo: style_loader(p[0]) for emo, p in emo_paths.items()})
    elif args.trainer == "seq2seq":
        scfg = Seq2SeqConfig(vocab_size=len(vocab),
                             embed_size=args.embed_size,
                             hidden_size=args.hidden_size,
                             num_layers=args.num_layers,
                             dropout=args.dropout,
                             max_seq_length=args.max_seq_length)
        params = s2s.init_params(key, scfg)
        head = enc_mod.init_head_params(jax.random.PRNGKey(args.seed + 1), ecfg)
        trainer = Seq2SeqTrainer(scfg, tcfg, vocab, params, head,
                                 log_path=args.log_path, mesh=mesh)
        trainer.train(
            loader(args.caption_path, tcfg.caption_batch_size),
            {emo: loader(p[0], tcfg.language_batch_size)
             for emo, p in emo_paths.items()},
            val_loader=loader(args.val_caption_path,
                              tcfg.caption_batch_size, train=False),
            val_emotion_loaders={
                emo: loader(p[1], tcfg.language_batch_size, train=False)
                for emo, p in emo_paths.items()})
    else:
        raise SystemExit(f"unknown --trainer {args.trainer}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--trainer", type=str, default="multitask",
                        choices=["multitask", "multitask_att", "transfer_fac",
                                 "transfer", "paper", "seq2seq"])
    parser.add_argument("--family", type=str, default="stylenet",
                        choices=["stylenet", "nic"])
    parser.add_argument("--attention", action="store_true")
    parser.add_argument("--no_augment", action="store_true",
                        help="disable train-time crop/flip; use cached eval-mode features")
    parser.add_argument("--device_resident", action="store_true",
                        help="pin train splits on device and run each epoch "
                             "as ONE jitted scan (requires --no_augment or "
                             "--feature_cache); splits over the feature "
                             "budget stream per-chunk buffers instead "
                             "(multitask/transfer trainers)")
    parser.add_argument("--feature_dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="storage dtype for --device_resident feature "
                             "arrays; bfloat16 halves every pin/stream "
                             "wall (the epoch programs cast each gathered "
                             "batch back to f32 — the only numerical "
                             "difference is the one-time storage rounding, "
                             "and the GPU's default f32 matmul precision "
                             "(TF32) rounds operands anyway)")
    parser.add_argument("--device_budget_gb", type=float, default=None,
                        help="device feature budget for --device_resident "
                             "(pin if the split fits; otherwise stream "
                             "double-buffered chunks of a third this size "
                             "— the epoch scan holds one extra copy of "
                             "the active buffer); pinning budgets 2x the "
                             "feature bytes for the epoch program's copy. "
                             "Default: a quarter of the GPU memory the "
                             "process reserved, 4 GiB elsewhere "
                             "(data/device.py:default_budget_bytes)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="train over all devices: ('data','model') mesh, "
                             "batch sharded over the data axis, gradient "
                             "all-reduce (SURVEY §2.5)")
    parser.add_argument("--tensor_parallel", type=int, default=1,
                        help="model-axis size for vocab-dim tensor "
                             "parallelism of the embedding/output head "
                             "(with --data_parallel)")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="multi-host: jax.distributed coordinator "
                             "host:port")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="resume/fine-tune source checkpoint")
    parser.add_argument("--data_name", type=str, default="flickr8k_id")
    from icee_tpu.cli.common import (add_data_flags, add_model_flags,
                                     add_train_flags)

    add_model_flags(parser)
    add_train_flags(parser)
    add_data_flags(parser)
    args = parser.parse_args()
    print(args)
    main(args)
