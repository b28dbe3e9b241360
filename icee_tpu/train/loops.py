"""Training regimes (reference SURVEY.md T1-T6) as host-side epoch drivers
over jitted steps.

All regimes share the reference's control policy (``train_multitask.py:
180-269``): per-epoch factual track then emotion track(s), teacher-forced
validation with loss / perplexity / top-5 / corpus BLEU-4, LR x0.8 after 4
non-improving epochs per track, early stop after 10 for all tracks, best-BLEU
checkpointing, and a beam-decoded sample caption printed per validation.

Differences from the reference are all mechanical, not semantic: batches are
fixed-shape with masks, the per-batch device loop is one jitted step, and the
CNN backbone runs once per unique image into a feature cache instead of every
epoch (``SURVEY.md §7`` — the backbone is frozen, so eval-mode features are
constant; pass ``backbone_train_bn`` features per-epoch for bit-faithful BN
drift if required).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from icee_tpu.core.config import (
    EMOTIONS,
    MODES,
    DecoderConfig,
    Seq2SeqConfig,
    TrainConfig,
    mode_id,
)
from icee_tpu.checkpoint.ckpt import CheckpointState, save_checkpoint
from icee_tpu.evaluation.bleu import corpus_bleu
from icee_tpu.evaluation.metrics import AverageMeter, perplexity
from icee_tpu.train import optim
from icee_tpu.train.steps import (
    make_attention_steps,
    make_caption_steps,
    make_seq2seq_steps,
)


def strip_specials(ids: Sequence[int], start: int, end: int) -> List[int]:
    """Drop <start>/<end> ids (val BLEU pre-processing,
    ``train_multitask.py:316-333``)."""
    return [int(w) for w in ids if w != start and w != end]


def _log(log_path: Optional[str], text: str) -> None:
    print(text)
    if log_path:
        with open(log_path, "a+") as f:
            f.write(text + "\n")


def _to_device(mesh, *arrays):
    """Host batch tensors -> device arrays; with a mesh, mesh-spanning
    arrays sharded over the data axis (per-host shard feeding via
    ``jax.make_array_from_process_local_data`` on multi-host)."""
    if mesh is None:
        return tuple(jnp.asarray(a) for a in arrays)
    from icee_tpu.parallel.data import global_batch

    return tuple(global_batch(mesh, np.asarray(a)) for a in arrays)


@dataclasses.dataclass
class EpochStats:
    loss: float
    top5: float = 0.0
    bleu4: float = 0.0
    batch_time: float = 0.0


class MultitaskTrainer:
    """T2/T3 (and the NIC copies): interleaved factual + single-emotion
    training with BLEU-driven plateau control.

    ``family``: 'factored' | 'nic' | 'factored_att' | 'nic_att'.
    Loaders yield :class:`icee_tpu.data.pipeline.CaptionBatch` whose
    ``images`` field holds encoder features — pooled (B, 2048->head) for the
    global families, spatial (B, P, 2048) for the attention families.
    """

    def __init__(
        self,
        cfg: DecoderConfig,
        tcfg: TrainConfig,
        vocab,
        dec_params,
        head_params=None,
        family: str = "factored",
        sample_fn: Optional[Callable] = None,
        log_path: Optional[str] = None,
        model_dir: str = "models",
        data_name: str = "flickr8k_id",
        metrics_path: Optional[str] = None,
        mesh=None,
    ) -> None:
        self.cfg, self.tcfg, self.vocab = cfg, tcfg, vocab
        self.family = family
        self.attention = family.endswith("_att")
        self.factored = family.startswith("factored")
        self.dec = dec_params
        self.head = head_params
        # multi-device training (SURVEY §2.5 DP row): params placed on the
        # ("data", "model") mesh BEFORE optimizer init so the optax moments
        # inherit the shardings; batches become mesh-spanning arrays in
        # _to_device and jit/GSPMD inserts the gradient all-reduce.  The
        # SAME jitted steps serve single- and multi-device runs.
        self.mesh = mesh
        if mesh is not None:
            self._place_params()
        self.sample_fn = sample_fn
        self.log_path = log_path
        self.model_dir = model_dir
        self.data_name = data_name
        from icee_tpu.utils.logging import MetricsLogger

        self.metrics = MetricsLogger(metrics_path)
        self.rng = jax.random.PRNGKey(tcfg.seed)

        self.optimizer = optim.make_adam(tcfg.lr_caption, tcfg)
        self.lang_optimizer = optim.make_adam(tcfg.lr_language, tcfg)
        if self.attention:
            steps = make_attention_steps(cfg, tcfg, self.optimizer,
                                         self.lang_optimizer, self.factored)
        else:
            steps = make_caption_steps(cfg, tcfg, self.optimizer,
                                       self.lang_optimizer, self.factored)
        self.factual_step, self.emotion_step, self.val_step = steps

        if self.attention:
            self.opt_state = self.optimizer.init(self.dec)
        else:
            self.opt_state = self.optimizer.init((self.dec, self.head))
        self.lang_opt_state = self.lang_optimizer.init(self.dec)

        self.epochs_since_improvement = {"factual": 0, "emotion": 0}
        self.best_bleu4 = {"factual": 0.0, "emotion": 0.0}
        self.start_epoch = 0
        if self.sample_fn is None and not self.attention:
            self.sample_fn = self._default_sample_fn

    def _place_params(self) -> None:
        """TP (vocab-dim) decoder placement + replicated head on the mesh."""
        from icee_tpu.parallel import train as ptrain

        self.dec = ptrain.place_decoder(self.dec, self.mesh)
        if self.head is not None:
            self.head = ptrain.place_replicated(self.head, self.mesh)

    def _to_device(self, *arrays):
        return _to_device(self.mesh, *arrays)

    def _default_sample_fn(self, dec, head, feat, style):
        """Beam-decode one caption from a pooled feature (the per-validation
        sample print, ``train_multitask.py:344-359``)."""
        import jax.numpy as jnp

        from icee_tpu.decode.beam import beam_search
        from icee_tpu.models import encoder as enc_mod
        from icee_tpu.models import factored_lstm as fl_mod
        from icee_tpu.models import lstm as nic_mod

        k = 5
        feats_head, _ = enc_mod.encode_global_from_pooled(head, feat, False)
        if self.factored:
            embed_fn = lambda t: fl_mod.embed(dec, t)  # noqa: E731
            step_fn = lambda x, s: fl_mod.decode_step(  # noqa: E731
                dec, x, s, jnp.asarray(style))
            init = fl_mod.initial_state(k, self.cfg)
        else:
            embed_fn = lambda t: nic_mod.embed(dec, t)  # noqa: E731
            step_fn = lambda x, s: nic_mod.decode_step(dec, x, s)  # noqa: E731
            init = nic_mod.initial_state(k, self.cfg)
        res = beam_search(
            embed_fn=embed_fn, step_fn=step_fn, init_model_state=init,
            start_token=self.vocab.start, end_token=self.vocab.end, k=k,
            max_seq_length=self.cfg.max_seq_length,
            vocab_size=self.cfg.vocab_size,
            first_input=jnp.tile(feats_head, (k, 1)))
        ids = np.asarray(res.tokens)[: int(res.length)]
        words = []
        for wid in ids:
            words.append(self.vocab.idx2word[int(wid)])
            if words[-1] == "<end>":
                break
        return words

    # -- single epochs ----------------------------------------------------

    def _next_rng(self):
        self.rng, k = jax.random.split(self.rng)
        return k

    def _run_train(self, loader, style: Optional[int], log_step: int,
                   tag: str, epoch: Optional[int] = None, pass_idx: int = 0,
                   start_row: int = 0, loss_prefix=None) -> EpochStats:
        from icee_tpu.data.device import DeviceCaptionData

        if isinstance(loader, DeviceCaptionData):
            return self._run_train_device(
                loader, style, log_step, tag, epoch=epoch, pass_idx=pass_idx,
                start_row=start_row, loss_prefix=loss_prefix)
        losses = AverageMeter()
        t0 = time.time()
        for i, batch in enumerate(loader):
            feats, caps, lens, smask = self._to_device(
                batch.images, batch.captions, batch.lengths,
                batch.sample_mask)
            if style is None or style == 0:
                if self.attention:
                    self.dec, self.opt_state, loss = self.factual_step(
                        self.dec, self.opt_state, feats, caps, lens, smask,
                        self._next_rng())
                else:
                    self.dec, self.head, self.opt_state, loss = \
                        self.factual_step(self.dec, self.head, self.opt_state,
                                          feats, caps, lens, smask,
                                          self._next_rng())
            else:
                s = jnp.asarray(style)
                if self.attention:
                    self.dec, self.lang_opt_state, loss = self.emotion_step(
                        self.dec, self.lang_opt_state, feats, caps, lens,
                        smask, s, self._next_rng())
                else:
                    self.dec, self.head, self.lang_opt_state, loss = \
                        self.emotion_step(self.dec, self.head,
                                          self.lang_opt_state, feats, caps,
                                          lens, smask, s, self._next_rng())
            if i % log_step == 0:
                print(f"Step [{i}/{len(loader)}], [{tag}], "
                      f"Loss: {float(loss):.4f}")
            losses.update(float(loss), int(batch.lengths.sum()))
        return EpochStats(loss=losses.avg, batch_time=time.time() - t0)

    def _device_apply_fn(self, factual: bool):
        """Shared single-batch body of the device-resident training
        programs: gather one minibatch from the pinned split
        (``data/device.gather_rows`` — copy-free slices, NOT ``jnp.take``,
        whose gather may copy the whole operand) and run the same
        step the host loop would.  The RNG split mirrors ``_run_train``'s
        ``_next_rng`` order exactly."""
        from icee_tpu.data.device import gather_rows

        step = self.factual_step if factual else self.emotion_step
        attention, mesh = self.attention, self.mesh
        if mesh is not None:
            from icee_tpu.parallel.mesh import batch_sharding

            bsh = batch_sharding(mesh)

        def apply(dec, head, opt_state, rng, images, captions, lengths,
                  bidx, b_img, bvalid, style):
            rng, k = jax.random.split(rng)
            # zero padded rows exactly like the host loader's batch
            # padding (BatchNorm batch statistics see every row, so
            # gather-padded features would perturb them); the f32 cast is
            # a no-op for f32 splits and restores the step's dtype for
            # narrow feature storage (from_examples(feature_dtype=...))
            feats = gather_rows(images, b_img).astype(jnp.float32)
            feats = feats * bvalid.reshape(
                (-1,) + (1,) * (feats.ndim - 1)).astype(feats.dtype)
            caps = jnp.take(captions, bidx, axis=0) * bvalid[:, None]
            lens = jnp.where(bvalid, jnp.take(lengths, bidx, axis=0), 0)
            if mesh is not None:
                # data arrays replicate across the mesh; reshard the
                # gathered batch over the data axis so the step runs DP
                feats = jax.lax.with_sharding_constraint(feats, bsh)
                caps = jax.lax.with_sharding_constraint(caps, bsh)
            if factual:
                if attention:
                    dec, opt_state, loss = step(
                        dec, opt_state, feats, caps, lens, bvalid, k)
                else:
                    dec, head, opt_state, loss = step(
                        dec, head, opt_state, feats, caps, lens, bvalid,
                        k)
            else:
                if attention:
                    dec, opt_state, loss = step(
                        dec, opt_state, feats, caps, lens, bvalid, style,
                        k)
                else:
                    dec, head, opt_state, loss = step(
                        dec, head, opt_state, feats, caps, lens, bvalid,
                        style, k)
            return dec, head, opt_state, rng, loss, lens.sum()

        return apply

    def _device_epoch_fn(self, factual: bool):
        """Jitted WHOLE-EPOCH program for a device-resident split: one
        ``lax.scan`` over shuffled batch-index rows running
        ``_device_apply_fn`` per batch — one dispatch per epoch instead of
        two host round-trips per batch (see ``data/device.py``).  Parameters
        after a device epoch are bit-identical to the host-loop epoch on
        the same batch composition.  NOTE: the scan threads ``images``
        through the XLA while-loop state, which copies it — this program
        needs ~2x the pinned feature bytes (``pin_plan`` keeps
        over-budget splits on the per-batch tier).
        """
        if not hasattr(self, "_depoch_cache"):
            self._depoch_cache = {}
        key = (factual, self.attention)
        fn = self._depoch_cache.get(key)
        if fn is not None:
            return fn
        apply = self._device_apply_fn(factual)

        def epoch(dec, head, opt_state, rng, images, captions, lengths,
                  idx, img_rows, valid, style):
            def body(carry, xs):
                dec, head, opt_state, rng = carry
                bidx, b_img, bvalid = xs
                dec, head, opt_state, rng, loss, ntok = apply(
                    dec, head, opt_state, rng, images, captions, lengths,
                    bidx, b_img, bvalid, style)
                return (dec, head, opt_state, rng), (loss, ntok)

            (dec, head, opt_state, rng), (losses, ntoks) = jax.lax.scan(
                body, (dec, head, opt_state, rng), (idx, img_rows, valid))
            return dec, head, opt_state, rng, losses, ntoks

        fn = jax.jit(epoch)
        self._depoch_cache[key] = fn
        return fn

    def _device_batch_fn(self, factual: bool):
        """Jitted SINGLE-BATCH program for the pinned-per-batch tier
        (``DeviceCaptionData.per_batch``): identical math and RNG chain to
        one ``_device_epoch_fn`` scan iteration, but with NO scan — no XLA
        while loop means the pinned feature array is read in place instead
        of being copied into the loop state, so splits between budget/2
        and budget stay device-resident (measured: the one-dispatch epoch
        needs ~2x feature bytes, ``scripts/probe_pin_copy.py``)."""
        if not hasattr(self, "_dbatch_cache"):
            self._dbatch_cache = {}
        key = (factual, self.attention)
        fn = self._dbatch_cache.get(key)
        if fn is None:
            fn = jax.jit(self._device_apply_fn(factual))
            self._dbatch_cache[key] = fn
        return fn

    @staticmethod
    def _init_loss_trace(nb, start_row, loss_prefix):
        """(nb,) loss/ntok traces with a resumed prefix restored (shared by
        the chunked, per-batch and streamed epoch loops)."""
        losses = np.zeros(nb, np.float64)
        ntoks = np.zeros(nb, np.float64)
        if loss_prefix is not None:
            pl_, pn_ = loss_prefix
            losses[:start_row] = np.asarray(pl_, np.float64)[:start_row]
            ntoks[:start_row] = np.asarray(pn_, np.float64)[:start_row]
        return losses, ntoks

    @staticmethod
    def _epoch_stats(losses, ntoks, log_step, tag, t0):
        """Step logging + token-weighted epoch loss (shared epilogue of
        every device-resident training loop)."""
        for i in range(0, len(losses), max(log_step, 1)):
            print(f"Step [{i}/{len(losses)}], [{tag}], "
                  f"Loss: {float(losses[i]):.4f}")
        total = float(ntoks.sum())
        avg = float((losses * ntoks).sum() / total) if total else 0.0
        return EpochStats(loss=avg, batch_time=time.time() - t0)

    def _run_train_device(self, ddata, style: Optional[int], log_step: int,
                          tag: str, epoch: Optional[int] = None,
                          pass_idx: int = 0, start_row: int = 0,
                          loss_prefix=None) -> EpochStats:
        """One training epoch over a :class:`DeviceCaptionData` split.

        With ``tcfg.progress_chunk > 0`` (and an ``epoch`` to label the
        record) the epoch runs as chunks of that many batch rows — one
        dispatch each, sequentially equivalent to the single whole-epoch
        scan — and a mid-epoch progress checkpoint
        (``checkpoint/progress.py``) is written after every chunk.
        ``start_row``/``loss_prefix`` restart a preempted pass at the last
        completed chunk boundary with its loss trace intact.
        """
        from icee_tpu.data.device import StreamedCaptionData

        if isinstance(ddata, StreamedCaptionData):
            return self._run_train_streamed(
                ddata, style, log_step, tag, epoch=epoch, pass_idx=pass_idx,
                start_row=start_row, loss_prefix=loss_prefix)
        if getattr(ddata, "per_batch", False):
            return self._run_train_device_per_batch(
                ddata, style, log_step, tag, epoch=epoch, pass_idx=pass_idx,
                start_row=start_row, loss_prefix=loss_prefix)
        t0 = time.time()
        factual = style is None or style == 0
        idx, valid = ddata.epoch_indices()
        img_rows = ddata.image_rows(idx)
        fn = self._device_epoch_fn(factual)
        style_arr = jnp.asarray(style if style is not None else 0)
        chunk = getattr(self.tcfg, "progress_chunk", 0)
        nb = idx.shape[0]
        if chunk and epoch is not None:
            losses, ntoks = self._init_loss_trace(nb, start_row, loss_prefix)
            for r0 in range(start_row, nb, chunk):
                r1 = min(r0 + chunk, nb)
                opt_state = self.opt_state if factual else self.lang_opt_state
                dec, head, opt_state, self.rng, ls, nt = fn(
                    self.dec, self.head, opt_state, self.rng,
                    ddata.images, ddata.captions, ddata.lengths,
                    jnp.asarray(idx[r0:r1]), jnp.asarray(img_rows[r0:r1]),
                    jnp.asarray(valid[r0:r1]), style_arr)
                self.dec, self.head = dec, head
                if factual:
                    self.opt_state = opt_state
                else:
                    self.lang_opt_state = opt_state
                losses[r0:r1] = np.asarray(ls, np.float64)
                ntoks[r0:r1] = np.asarray(nt, np.float64)
                self._save_progress(epoch, pass_idx, r1, losses, ntoks)
        else:
            opt_state = self.opt_state if factual else self.lang_opt_state
            dec, head, opt_state, self.rng, losses, ntoks = fn(
                self.dec, self.head, opt_state, self.rng,
                ddata.images, ddata.captions, ddata.lengths,
                jnp.asarray(idx), jnp.asarray(img_rows),
                jnp.asarray(valid), style_arr)
            self.dec, self.head = dec, head
            if factual:
                self.opt_state = opt_state
            else:
                self.lang_opt_state = opt_state
            losses = np.asarray(losses, np.float64)
            ntoks = np.asarray(ntoks, np.float64)
        return self._epoch_stats(losses, ntoks, log_step, tag, t0)

    def _run_train_device_per_batch(self, ddata, style: Optional[int],
                                    log_step: int, tag: str,
                                    epoch: Optional[int] = None,
                                    pass_idx: int = 0, start_row: int = 0,
                                    loss_prefix=None) -> EpochStats:
        """One training epoch over a pinned-per-batch split
        (``DeviceCaptionData.per_batch`` — features fit HBM once but not
        twice, so the one-dispatch scan program's while-loop copy would
        OOM; see ``pin_plan``).

        Same epoch composition and RNG split order as the whole-epoch scan
        (bit-identical parameters); each batch is one no-scan jitted
        dispatch reading the pinned features in place.  Loss transfers are
        deferred to the end (or to progress-checkpoint boundaries) so the
        dispatch queue stays full — the loop never blocks on a device
        value between batches.
        """
        t0 = time.time()
        factual = style is None or style == 0
        idx, valid = ddata.epoch_indices()
        img_rows = ddata.image_rows(idx)
        fn = self._device_batch_fn(factual)
        style_arr = jnp.asarray(style if style is not None else 0)
        nb = idx.shape[0]
        prog_every = int(getattr(self.tcfg, "progress_chunk", 0) or 0)
        save_progress = prog_every > 0 and epoch is not None
        last_saved = start_row
        losses, ntoks = self._init_loss_trace(nb, start_row, loss_prefix)
        pending = []
        for r in range(start_row, nb):
            opt_state = self.opt_state if factual else self.lang_opt_state
            dec, head, opt_state, self.rng, ls, nt = fn(
                self.dec, self.head, opt_state, self.rng,
                ddata.images, ddata.captions, ddata.lengths,
                jnp.asarray(idx[r]), jnp.asarray(img_rows[r]),
                jnp.asarray(valid[r]), style_arr)
            self.dec, self.head = dec, head
            if factual:
                self.opt_state = opt_state
            else:
                self.lang_opt_state = opt_state
            pending.append((r, ls, nt))
            if save_progress and (r + 1 - last_saved >= prog_every
                                  or r + 1 == nb):
                for p, pls, pnt in pending:
                    losses[p] = float(pls)
                    ntoks[p] = float(pnt)
                pending = []
                last_saved = r + 1
                self._save_progress(epoch, pass_idx, r + 1, losses, ntoks)
        for p, pls, pnt in pending:
            losses[p] = float(pls)
            ntoks[p] = float(pnt)
        return self._epoch_stats(losses, ntoks, log_step, tag, t0)

    def _run_train_streamed(self, ddata, style: Optional[int], log_step: int,
                            tag: str, epoch: Optional[int] = None,
                            pass_idx: int = 0, start_row: int = 0,
                            loss_prefix=None) -> EpochStats:
        """One training epoch over a :class:`StreamedCaptionData` split
        (features exceed the HBM pin budget — ``data/device.py``).

        Same epoch composition and RNG split order as the pinned device
        epoch (bit-identical parameters); the epoch runs as
        ``rows_per_chunk``-row scan dispatches, each over a compact
        fixed-``capacity`` feature buffer holding the chunk's deduplicated
        unique images.  Host gather + async ``device_put`` of chunk c+1
        overlap chunk c's device compute; loss traces are only materialized
        after the last dispatch (unless mid-epoch progress checkpoints are
        on, which must block per chunk anyway).
        """
        t0 = time.time()
        factual = style is None or style == 0
        idx, valid = ddata.epoch_indices()
        img_rows = ddata.image_rows(idx)
        fn = self._device_epoch_fn(factual)
        style_arr = jnp.asarray(style if style is not None else 0)
        nb = idx.shape[0]
        R = ddata.rows_per_chunk
        prog_every = int(getattr(self.tcfg, "progress_chunk", 0) or 0)
        save_progress = prog_every > 0 and epoch is not None
        last_saved = start_row
        losses, ntoks = self._init_loss_trace(nb, start_row, loss_prefix)
        bounds = [(r0, min(r0 + R, nb)) for r0 in range(start_row, nb, R)]
        pending = []
        nxt = None
        if bounds:
            f, remap = ddata.chunk_features(
                img_rows[bounds[0][0]:bounds[0][1]])
            nxt = (ddata.put_features(f), remap)
        for ci, (r0, r1) in enumerate(bounds):
            imgs, remap = nxt
            opt_state = self.opt_state if factual else self.lang_opt_state
            dec, head, opt_state, self.rng, ls, nt = fn(
                self.dec, self.head, opt_state, self.rng,
                imgs, ddata.captions, ddata.lengths,
                jnp.asarray(idx[r0:r1]), jnp.asarray(remap),
                jnp.asarray(valid[r0:r1]), style_arr)
            self.dec, self.head = dec, head
            if factual:
                self.opt_state = opt_state
            else:
                self.lang_opt_state = opt_state
            nxt = None
            if ci + 1 < len(bounds):
                # prepare + enqueue the next buffer while this chunk runs
                n0, n1 = bounds[ci + 1]
                f, remap = ddata.chunk_features(img_rows[n0:n1])
                nxt = (ddata.put_features(f), remap)
            pending.append((r0, r1, ls, nt))
            # save only every progress_chunk rows (matching the pinned
            # path's record granularity) — still aligned to streamed-chunk
            # boundaries so resume stays valid; chunks between saves keep
            # their loss transfers deferred to preserve the prefetch
            # overlap (ADVICE r4)
            if save_progress and (r1 - last_saved >= prog_every or r1 == nb):
                for p0, p1, pls, pnt in pending:
                    losses[p0:p1] = np.asarray(pls, np.float64)
                    ntoks[p0:p1] = np.asarray(pnt, np.float64)
                pending = []
                last_saved = r1
                self._save_progress(epoch, pass_idx, r1, losses, ntoks)
        for r0, r1, ls, nt in pending:
            losses[r0:r1] = np.asarray(ls, np.float64)
            ntoks[r0:r1] = np.asarray(nt, np.float64)
        return self._epoch_stats(losses, ntoks, log_step, tag, t0)

    # -- mid-epoch progress (checkpoint/progress.py) ------------------------

    def _save_progress(self, epoch: int, pass_idx: int, row: int,
                       losses, ntoks) -> None:
        from icee_tpu.checkpoint import progress as prog_mod

        record = prog_mod.make_record(
            epoch=epoch, pass_idx=pass_idx, row=row, rng=self.rng,
            params={"decoder": self.dec, "head": self.head},
            opt_states={"optimizer": self.opt_state,
                        "lang_optimizer": self.lang_opt_state},
            losses=losses, ntoks=ntoks,
            epochs_since_improvement=self.epochs_since_improvement,
            best_bleu4=self.best_bleu4)
        prog_mod.save_progress(self.model_dir, self.data_name, record)
        hook = getattr(self, "_progress_hook", None)
        if hook is not None:
            hook(epoch, pass_idx, row)

    def _clear_progress(self) -> None:
        """Drop the mid-epoch record once a train loop runs to completion —
        a later fresh run in the same model_dir must not 'resume' past it."""
        if getattr(self.tcfg, "progress_chunk", 0):
            from icee_tpu.checkpoint import progress as prog_mod

            prog_mod.clear_progress(self.model_dir, self.data_name)

    def _resume_progress(self, loaders_by_pass: dict) -> Optional[dict]:
        """If a progress record exists, restore full training state from it
        and return ``{"epoch", "pass_idx", "row", "losses", "ntoks"}``.

        ``loaders_by_pass`` maps pass_idx -> the TRAIN loader of that pass;
        the in-flight pass's loader sizes the loss-trace template, and every
        shuffling train loader is fast-forwarded one ``epoch_indices()``
        call per COMPLETED epoch so the resumed epoch's shuffle matches the
        killed run's (``DeviceCaptionData`` is deterministic from its seed).
        """
        from icee_tpu.checkpoint import progress as prog_mod
        from icee_tpu.data.device import DeviceCaptionData

        raw = prog_mod.peek_progress(self.model_dir, self.data_name)
        if raw is None:
            return None
        epoch = int(raw["epoch"])
        pass_idx = int(raw["pass_idx"])
        row = int(raw["row"])
        nb = int(np.asarray(raw["losses"]).shape[0])
        template = prog_mod.make_record(
            epoch=0, pass_idx=0, row=0, rng=self.rng,
            params={"decoder": self.dec, "head": self.head},
            opt_states={"optimizer": self.opt_state,
                        "lang_optimizer": self.lang_opt_state},
            losses=np.zeros(nb, np.float32), ntoks=np.zeros(nb, np.float32),
            epochs_since_improvement=self.epochs_since_improvement,
            best_bleu4=self.best_bleu4)
        rec = prog_mod.load_progress(self.model_dir, self.data_name, template)
        self.dec = rec["params"]["decoder"]
        self.head = rec["params"]["head"]
        self.opt_state = rec["opt_states"]["optimizer"]
        self.lang_opt_state = rec["opt_states"]["lang_optimizer"]
        self.rng = jnp.asarray(rec["rng"])
        if self.mesh is not None:
            self._place_params()
        self.epochs_since_improvement = {
            k: int(v) for k, v in rec["epochs_since_improvement"].items()}
        self.best_bleu4 = {
            k: float(v) for k, v in rec["best_bleu4"].items()}
        self.start_epoch = epoch
        for _ in range(epoch):           # completed epochs
            for ld in loaders_by_pass.values():
                if isinstance(ld, DeviceCaptionData) and ld.shuffle:
                    ld.epoch_indices()
        _log(self.log_path,
             f"RESUMING mid-epoch: epoch {epoch}, pass {pass_idx}, "
             f"row {row}/{nb}")
        return {"epoch": epoch, "pass_idx": pass_idx, "row": row,
                "losses": np.asarray(rec["losses"]),
                "ntoks": np.asarray(rec["ntoks"])}

    def _val_epoch_fn(self):
        """Jitted WHOLE-EPOCH validation program for a device-resident
        split: one ``lax.scan`` over batch-index rows running ``val_step``
        per batch — loss/top-5/greedy preds for the entire split in ONE
        dispatch (the teacher-forced half of ``train_multitask.py:272-361``;
        BLEU stays on host over the returned preds)."""
        if not hasattr(self, "_dval_cache"):
            self._dval_cache = None
        if self._dval_cache is not None:
            return self._dval_cache
        apply = self._val_apply_fn()

        def epoch(dec, head, images, captions, lengths, idx, img_rows,
                  valid, style):
            def body(_, xs):
                bidx, b_img, bvalid = xs
                return 0, apply(dec, head, images, captions, lengths,
                                bidx, b_img, bvalid, style)

            _, out = jax.lax.scan(body, 0, (idx, img_rows, valid))
            return out

        self._dval_cache = jax.jit(epoch)
        return self._dval_cache

    def _val_apply_fn(self):
        """Shared single-batch body of the device-resident validation
        programs (copy-free pinned gather, same metrics as the host
        ``_run_val`` batch)."""
        from icee_tpu.data.device import gather_rows

        val_step, attention, mesh = self.val_step, self.attention, self.mesh
        if mesh is not None:
            from icee_tpu.parallel.mesh import batch_sharding

            bsh = batch_sharding(mesh)

        def apply(dec, head, images, captions, lengths, bidx, b_img,
                  bvalid, style):
            feats = gather_rows(images, b_img).astype(jnp.float32)
            feats = feats * bvalid.reshape(
                (-1,) + (1,) * (feats.ndim - 1)).astype(feats.dtype)
            caps = jnp.take(captions, bidx, axis=0) * bvalid[:, None]
            lens = jnp.where(bvalid, jnp.take(lengths, bidx, axis=0), 0)
            if mesh is not None:
                feats = jax.lax.with_sharding_constraint(feats, bsh)
                caps = jax.lax.with_sharding_constraint(caps, bsh)
            if attention:
                loss, top5, preds = val_step(dec, feats, caps, lens,
                                             bvalid, style)
            else:
                loss, top5, preds = val_step(dec, head, feats, caps,
                                             lens, bvalid, style)
            return loss, top5, lens.sum(), preds

        return apply

    def _val_batch_fn(self):
        """Jitted SINGLE-BATCH validation program for the pinned-per-batch
        tier (no scan — the pinned features are read in place instead of
        being copied into the while-loop state; see ``pin_plan``)."""
        if getattr(self, "_dval_batch_cache", None) is None:
            self._dval_batch_cache = jax.jit(self._val_apply_fn())
        return self._dval_batch_cache

    def _run_val_device(self, ddata, style: int) -> EpochStats:
        """Whole-split validation over a :class:`DeviceCaptionData` —
        metrics identical to the host ``_run_val`` on the same split.
        :class:`StreamedCaptionData` splits run the same program per
        feature chunk (``_run_train_streamed``'s plan) instead of one
        whole-split dispatch."""
        from icee_tpu.data.device import StreamedCaptionData

        t0 = time.time()
        idx, valid = ddata.epoch_indices()
        fn = self._val_epoch_fn()
        if isinstance(ddata, StreamedCaptionData):
            img_rows = ddata.image_rows(idx)
            R = ddata.rows_per_chunk
            nb = idx.shape[0]
            bounds = [(r0, min(r0 + R, nb)) for r0 in range(0, nb, R)]
            outs, nxt = [], None
            if bounds:
                f, remap = ddata.chunk_features(
                    img_rows[bounds[0][0]:bounds[0][1]])
                nxt = (ddata.put_features(f), remap)
            for ci, (r0, r1) in enumerate(bounds):
                imgs, remap = nxt
                outs.append(fn(
                    self.dec, self.head, imgs, ddata.captions, ddata.lengths,
                    jnp.asarray(idx[r0:r1]), jnp.asarray(remap),
                    jnp.asarray(valid[r0:r1]), jnp.asarray(style)))
                nxt = None
                if ci + 1 < len(bounds):
                    n0, n1 = bounds[ci + 1]
                    f, remap = ddata.chunk_features(img_rows[n0:n1])
                    nxt = (ddata.put_features(f), remap)
            losses = np.concatenate(
                [np.asarray(o[0], np.float64) for o in outs])
            top5s = np.concatenate(
                [np.asarray(o[1], np.float64) for o in outs])
            ntoks = np.concatenate(
                [np.asarray(o[2], np.float64) for o in outs])
            preds = np.concatenate([np.asarray(o[3]) for o in outs], axis=0)
        elif getattr(ddata, "per_batch", False):
            # pinned-per-batch tier: one no-scan dispatch per batch (the
            # whole-epoch scan would copy the pinned features; pin_plan)
            bfn = self._val_batch_fn()
            img_rows = ddata.image_rows(idx)
            outs = [bfn(self.dec, self.head, ddata.images, ddata.captions,
                        ddata.lengths, jnp.asarray(idx[b]),
                        jnp.asarray(img_rows[b]), jnp.asarray(valid[b]),
                        jnp.asarray(style))
                    for b in range(idx.shape[0])]
            losses = np.asarray([float(o[0]) for o in outs], np.float64)
            top5s = np.asarray([float(o[1]) for o in outs], np.float64)
            ntoks = np.asarray([float(o[2]) for o in outs], np.float64)
            preds = np.stack([np.asarray(o[3]) for o in outs], axis=0)
        else:
            losses, top5s, ntoks, preds = fn(
                self.dec, self.head, ddata.images, ddata.captions,
                ddata.lengths, jnp.asarray(idx),
                jnp.asarray(ddata.image_rows(idx)),
                jnp.asarray(valid), jnp.asarray(style))
            losses = np.asarray(losses, np.float64)
            top5s = np.asarray(top5s, np.float64)
            ntoks = np.asarray(ntoks, np.float64)
            preds = np.asarray(preds)                  # (nb, B, T)
        lens_host = np.asarray(ddata.lengths)[idx]     # (nb, B)
        start, end = self.vocab.start, self.vocab.end
        shift = 1 if self.attention else 0
        references, hypotheses = [], []
        for b in range(idx.shape[0]):
            for j in range(idx.shape[1]):
                if not valid[b, j]:
                    continue
                ei = int(idx[b, j])
                references.append([strip_specials(r, start, end)
                                   for r in ddata.references[ei]])
                L = max(int(lens_host[b, j]) - shift, 0)
                hypotheses.append(
                    strip_specials(preds[b, j, :L].tolist(), start, end))
        bleu4 = corpus_bleu(references, hypotheses)
        total = float(ntoks.sum())
        loss = float((losses * ntoks).sum() / total) if total else 0.0
        top5 = float((top5s * ntoks).sum() / total) if total else 0.0
        if self.sample_fn is not None:
            # the host loop samples from the first row of the last batch
            ui = int(ddata.image_rows(idx[-1:, :1])[0, 0])
            if isinstance(ddata, StreamedCaptionData):
                feat = ddata.sample_feature(ui)
            else:
                feat = ddata.images[ui:ui + 1]
            print(self.sample_fn(self.dec, self.head,
                                 jnp.asarray(feat, jnp.float32), style))
        return EpochStats(loss=loss, top5=top5, bleu4=bleu4,
                          batch_time=time.time() - t0)

    def _run_val(self, loader, style: int) -> EpochStats:
        from icee_tpu.data.device import DeviceCaptionData

        if isinstance(loader, DeviceCaptionData):
            return self._run_val_device(loader, style)
        losses, top5s = AverageMeter(), AverageMeter()
        references, hypotheses = [], []
        start, end = self.vocab.start, self.vocab.end
        t0 = time.time()
        last_feat = None
        for batch in loader:
            feats, caps_d, lens_d, smask_d = self._to_device(
                batch.images, batch.captions, batch.lengths,
                batch.sample_mask)
            loss, top5, preds = self.val_step(
                self.dec, *(() if self.attention else (self.head,)),
                feats, caps_d, lens_d, smask_d, jnp.asarray(style))
            n_tok = int(batch.lengths.sum())
            losses.update(float(loss), n_tok)
            top5s.update(float(top5), n_tok)
            preds = np.asarray(preds)
            shift = 1 if self.attention else 0
            for b in range(batch.batch_size):
                if not batch.sample_mask[b]:
                    continue
                refs = [strip_specials(r, start, end)
                        for r in batch.references[b]]
                references.append(refs)
                L = max(int(batch.lengths[b]) - shift, 0)
                hypotheses.append(
                    strip_specials(preds[b, :L].tolist(), start, end))
            last_feat = feats
        bleu4 = corpus_bleu(references, hypotheses)
        if self.sample_fn is not None and last_feat is not None:
            caption = self.sample_fn(self.dec, self.head, last_feat[0:1], style)
            print(caption)
        return EpochStats(loss=losses.avg, top5=top5s.avg, bleu4=bleu4,
                          batch_time=time.time() - t0)

    # -- full regime ------------------------------------------------------

    def train(self, data_loader, val_loader, emotion_loader, val_emotion_loader,
              num_epochs: Optional[int] = None) -> Dict:
        tcfg = self.tcfg
        num_epochs = num_epochs or tcfg.num_epochs
        emo = mode_id(tcfg.mode)
        prog = None
        if getattr(tcfg, "progress_chunk", 0):
            prog = self._resume_progress({0: data_loader, 1: emotion_loader})
        for epoch in range(self.start_epoch, num_epochs):
            # mid-epoch resume: passes before prog["pass_idx"] already ran
            # (their validation too — the record's counters include it), the
            # in-flight pass restarts at prog["row"].  The epoch-start
            # decay/early-stop block also already ran in the killed run
            # (captured in the record's opt states), so it must not re-run.
            resuming = prog is not None and prog["epoch"] == epoch
            if not resuming:
                imp_fac = self.epochs_since_improvement["factual"]
                imp_emo = self.epochs_since_improvement["emotion"]
                if imp_fac >= tcfg.early_stop_patience and \
                        imp_emo >= tcfg.early_stop_patience:
                    self.metrics.log("early_stop", epoch=epoch,
                                     imp_fac=imp_fac, imp_emo=imp_emo)
                    break
                if imp_fac > 0 and imp_fac % tcfg.lr_decay_patience == 0:
                    lr = optim.decay_lr(self.opt_state, tcfg.lr_decay_factor)
                    _log(self.log_path, f"DECAYING learning rate to {lr:f}")
                    self.metrics.log("lr_decay", epoch=epoch, track="factual",
                                     lr=lr)
                if imp_emo > 0 and imp_emo % tcfg.lr_decay_patience == 0:
                    lr = optim.decay_lr(self.lang_opt_state,
                                        tcfg.lr_decay_factor)
                    _log(self.log_path,
                         f"DECAYING language learning rate to {lr:f}")
                    self.metrics.log("lr_decay", epoch=epoch, track="emotion",
                                     lr=lr)

            # factual track
            if resuming and prog["pass_idx"] > 0:
                # complete (validated, counted) — burn its shuffle draw so
                # later epochs' batch composition matches the killed run
                from icee_tpu.data.device import DeviceCaptionData

                if isinstance(data_loader, DeviceCaptionData) and \
                        data_loader.shuffle:
                    data_loader.epoch_indices()
                _log(self.log_path,
                     f"Epoch [{epoch}/{num_epochs}], [FAC], resumed past "
                     "(completed before preemption)")
            else:
                fac_kw = {}
                if resuming:
                    fac_kw = dict(start_row=prog["row"],
                                  loss_prefix=(prog["losses"], prog["ntoks"]))
                tr = self._run_train(data_loader, 0, tcfg.log_step, "FAC",
                                     epoch=epoch, pass_idx=0, **fac_kw)
                va = self._run_val(val_loader, 0)
                _log(self.log_path,
                     f"Epoch [{epoch}/{num_epochs}], [FAC], "
                     f"Batch Time: {tr.batch_time + va.batch_time:.3f}, "
                     f"Top-5 Acc: {va.top5:.3f}, BLEU-4 Score: {va.bleu4}\n"
                     f"\tTrain Loss: {tr.loss:.4f} | "
                     f"Train Perplexity: {perplexity(tr.loss):5.4f}\n"
                     f"\tVal   Loss: {va.loss:.4f} | "
                     f"Val   Perplexity: {perplexity(va.loss):5.4f}")
                self.metrics.log("epoch_factual", epoch=epoch,
                                 train_loss=tr.loss,
                                 val_loss=va.loss, top5=va.top5,
                                 bleu4=va.bleu4,
                                 lr=optim.get_lr(self.opt_state))
                is_best_fac = va.bleu4 > self.best_bleu4["factual"]
                self.best_bleu4["factual"] = max(va.bleu4,
                                                 self.best_bleu4["factual"])
                self.epochs_since_improvement["factual"] = (
                    0 if is_best_fac
                    else self.epochs_since_improvement["factual"] + 1)

            # emotion track (single --mode emotion, train_multitask.py:139-147)
            emo_kw = {}
            if resuming and prog["pass_idx"] == 1:
                emo_kw = dict(start_row=prog["row"],
                              loss_prefix=(prog["losses"], prog["ntoks"]))
            if resuming:
                prog = None            # consumed; later epochs run normally
            tr_e = self._run_train(emotion_loader, emo, tcfg.log_step_emotion,
                                   tcfg.mode[:3].upper(), epoch=epoch,
                                   pass_idx=1, **emo_kw)
            va_e = self._run_val(val_emotion_loader, emo)
            _log(self.log_path,
                 f"Epoch [{epoch}/{num_epochs}], [{tcfg.mode[:3].upper()}], "
                 f"Top-5 Acc: {va_e.top5:.3f}, BLEU-4 Score: {va_e.bleu4}\n"
                 f"\tTrain Loss: {tr_e.loss:.4f} | "
                 f"Train Perplexity: {perplexity(tr_e.loss):5.4f}\n"
                 f"\tVal   Loss: {va_e.loss:.4f} | "
                 f"Val   Perplexity: {perplexity(va_e.loss):5.4f}")
            self.metrics.log("epoch_emotion", epoch=epoch, mode=tcfg.mode,
                             train_loss=tr_e.loss, val_loss=va_e.loss,
                             top5=va_e.top5, bleu4=va_e.bleu4,
                             lr=optim.get_lr(self.lang_opt_state))
            is_best_emo = va_e.bleu4 > self.best_bleu4["emotion"]
            self.best_bleu4["emotion"] = max(va_e.bleu4,
                                             self.best_bleu4["emotion"])
            self.epochs_since_improvement["emotion"] = (
                0 if is_best_emo
                else self.epochs_since_improvement["emotion"] + 1)

            self.save(epoch, is_best_emo)
        self._clear_progress()
        return {"best_bleu4": self.best_bleu4}

    def train_factual_only(self, data_loader, val_loader,
                           num_epochs: Optional[int] = None) -> Dict:
        """T4: stage-1 factual pretraining (``train_transfer_fac.py:83-160``);
        produces the FAC_BEST checkpoint the transfer stage resumes from."""
        tcfg = self.tcfg
        num_epochs = num_epochs or tcfg.num_epochs
        prog = None
        if getattr(tcfg, "progress_chunk", 0):
            prog = self._resume_progress({0: data_loader})
        for epoch in range(self.start_epoch, num_epochs):
            resuming = prog is not None and prog["epoch"] == epoch
            fac_kw = {}
            if resuming:
                fac_kw = dict(start_row=prog["row"],
                              loss_prefix=(prog["losses"], prog["ntoks"]))
                prog = None
            else:
                imp = self.epochs_since_improvement["factual"]
                if imp >= tcfg.early_stop_patience:
                    break
                if imp > 0 and imp % tcfg.lr_decay_patience == 0:
                    optim.decay_lr(self.opt_state, tcfg.lr_decay_factor)
            tr = self._run_train(data_loader, 0, tcfg.log_step, "FAC",
                                 epoch=epoch, pass_idx=0, **fac_kw)
            va = self._run_val(val_loader, 0)
            _log(self.log_path,
                 f"Epoch [{epoch}/{num_epochs}], [FAC], Top-5 Acc: "
                 f"{va.top5:.3f}, BLEU-4 Score: {va.bleu4}\n"
                 f"\tTrain Loss: {tr.loss:.4f} | Val Loss: {va.loss:.4f}")
            is_best = va.bleu4 > self.best_bleu4["factual"]
            self.best_bleu4["factual"] = max(va.bleu4,
                                             self.best_bleu4["factual"])
            self.epochs_since_improvement["factual"] = (
                0 if is_best else self.epochs_since_improvement["factual"] + 1)
            self.save(epoch, is_best, mode_tag="FAC")
        self._clear_progress()
        return {"best_bleu4": self.best_bleu4}

    def restore(self, path: str) -> None:
        """Full resume — params, BOTH optimizer states, epoch and plateau
        counters (the reference's checkpoint_path path,
        ``train_multitask.py:169-177``).  Builds the template from this
        trainer's freshly-initialized state so optax state types restore
        exactly."""
        from icee_tpu.checkpoint.ckpt import CheckpointState, load_checkpoint

        template = CheckpointState(
            epoch=0,
            epochs_since_improvement=self.epochs_since_improvement,
            best_bleu4=self.best_bleu4,
            params={"decoder": self.dec, "head": self.head},
            opt_states={"optimizer": self.opt_state,
                        "lang_optimizer": self.lang_opt_state},
        ).as_pytree()
        restored = load_checkpoint(path, template)
        self.dec = restored["params"]["decoder"]
        self.head = restored["params"]["head"]
        self.opt_state = restored["opt_states"]["optimizer"]
        self.lang_opt_state = restored["opt_states"]["lang_optimizer"]
        if self.mesh is not None:
            # re-place restored host arrays; opt-state moments re-shard on
            # the first jitted step (GSPMD propagates from the params)
            self._place_params()
        self.start_epoch = int(restored["epoch"]) + 1
        self.epochs_since_improvement = {
            k: int(v) for k, v in restored["epochs_since_improvement"].items()
        }
        self.best_bleu4 = {
            k: float(v) for k, v in restored["best_bleu4"].items()
        }

    def save(self, epoch: int, is_best: bool, mode_tag: Optional[str] = None):
        state = CheckpointState(
            epoch=epoch,
            epochs_since_improvement=self.epochs_since_improvement,
            best_bleu4=self.best_bleu4,
            params={"decoder": self.dec, "head": self.head},
            opt_states={"optimizer": self.opt_state,
                        "lang_optimizer": self.lang_opt_state},
        )
        save_checkpoint(self.model_dir, self.data_name,
                        mode_tag or self.tcfg.mode[:3].upper(), state, is_best)


class TransferTrainer(MultitaskTrainer):
    """T5: stage-2 transfer fine-tune from a factual checkpoint.

    StyleNet: language optimizer masked to style-S tensors + output head
    (``train_transfer.py:94-115``); NIC: masked to the LSTM cell
    (``nic/train_transfer.py:92-96``).  Supervised vs unsupervised is purely
    a data question (paired vs unpaired emotion corpus) — same loop.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from icee_tpu.models.factored_lstm import style_param_mask

        if self.factored:
            mask = style_param_mask(self.dec, include_output_head=True)
        else:
            mask = jax.tree_util.tree_map(lambda _: False, self.dec)
            mask["cell"] = jax.tree_util.tree_map(lambda _: True,
                                                  self.dec["cell"])
        self.lang_optimizer = optim.make_adam(
            self.tcfg.lr_language, self.tcfg, param_mask=mask)
        steps = (make_attention_steps if self.attention else make_caption_steps)(
            self.cfg, self.tcfg, self.optimizer, self.lang_optimizer,
            self.factored)
        self.factual_step, self.emotion_step, self.val_step = steps
        self.lang_opt_state = self.lang_optimizer.init(self.dec)

    def train_transfer(self, emotion_loader, val_emotion_loader,
                       num_epochs: Optional[int] = None) -> Dict:
        """Emotion-only fine-tuning loop (``train_transfer.py:128-207``)."""
        tcfg = self.tcfg
        num_epochs = num_epochs or tcfg.num_epochs
        emo = mode_id(tcfg.mode)
        prog = None
        if getattr(tcfg, "progress_chunk", 0):
            prog = self._resume_progress({0: emotion_loader})
        for epoch in range(self.start_epoch, num_epochs):
            resuming = prog is not None and prog["epoch"] == epoch
            emo_kw = {}
            if resuming:
                emo_kw = dict(start_row=prog["row"],
                              loss_prefix=(prog["losses"], prog["ntoks"]))
                prog = None
            else:
                imp = self.epochs_since_improvement["emotion"]
                if imp >= tcfg.early_stop_patience:
                    break
                if imp > 0 and imp % tcfg.lr_decay_patience == 0:
                    optim.decay_lr(self.lang_opt_state, tcfg.lr_decay_factor)
            tr = self._run_train(emotion_loader, emo, tcfg.log_step_emotion,
                                 tcfg.mode[:3].upper(), epoch=epoch,
                                 pass_idx=0, **emo_kw)
            va = self._run_val(val_emotion_loader, emo)
            _log(self.log_path,
                 f"Epoch [{epoch}/{num_epochs}], [{tcfg.mode[:3].upper()}], "
                 f"Top-5 Acc: {va.top5:.3f}, BLEU-4 Score: {va.bleu4}\n"
                 f"\tTrain Loss: {tr.loss:.4f} | Val Loss: {va.loss:.4f}")
            is_best = va.bleu4 > self.best_bleu4["emotion"]
            self.best_bleu4["emotion"] = max(va.bleu4,
                                             self.best_bleu4["emotion"])
            self.epochs_since_improvement["emotion"] = (
                0 if is_best else self.epochs_since_improvement["emotion"] + 1)
            self.save(epoch, is_best)
        self._clear_progress()
        return {"best_bleu4": self.best_bleu4}


class PaperRegimeTrainer(MultitaskTrainer):
    """T1: the StyleNet-paper regime (``stylenet/train.py``) — factual pass
    plus *text-only* emotion passes, one Adam per emotion over that emotion's
    S slice (``train.py:135-150``).

    The reference script is stale (its 3-tuple unpack crashes on the 4-tuple
    collate, ``train.py:232`` — SURVEY.md §7 quirks); this implementation
    realizes the intended regime on the working data layer.  Text-only
    batches carry no features (``features=None`` path of the decoder).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.style_optimizers = {}
        self.style_opt_states = {}
        for emo in EMOTIONS:
            sid = mode_id(emo)
            tx = optim.make_style_adam(self.tcfg.lr_language, sid, self.tcfg)
            self.style_optimizers[emo] = tx
            self.style_opt_states[emo] = tx.init(self.dec)
        # text-only emotion step: no features, per-style optimizer
        cfg, tcfg = self.cfg, self.tcfg
        from icee_tpu.evaluation.metrics import masked_cross_entropy
        from icee_tpu.models import factored_lstm as fl_mod
        import optax as _optax

        def make_step(tx):
            @jax.jit
            def step(dec, opt_state, captions, lengths, sample_mask, style, rng):
                def loss_fn(d):
                    logits = fl_mod.forward(
                        d, cfg, captions, None, style,
                        tcfg.teacher_forcing_ratio, rng, True)
                    return masked_cross_entropy(logits, captions, lengths,
                                                sample_mask)

                loss, grads = jax.value_and_grad(loss_fn)(dec)
                updates, opt_state = tx.update(grads, opt_state, dec)
                return _optax.apply_updates(dec, updates), opt_state, loss

            return step

        self.style_steps = {emo: make_step(self.style_optimizers[emo])
                            for emo in EMOTIONS}

    def _style_epoch_fn(self, emo: str):
        """Jitted whole-epoch program for a text-only style corpus pinned on
        device (``data/device.from_styled``): one ``lax.scan`` over shuffled
        batch-index rows running that emotion's S-slice step — the device
        analogue of the host loop in :meth:`train` (RNG split order
        identical, so parameters bit-match the host epoch)."""
        if not hasattr(self, "_sepoch_cache"):
            self._sepoch_cache = {}
        fn = self._sepoch_cache.get(emo)
        if fn is not None:
            return fn
        step = self.style_steps[emo]
        mesh = self.mesh
        if mesh is not None:
            from icee_tpu.parallel.mesh import batch_sharding

            bsh = batch_sharding(mesh)

        def epoch(dec, opt_state, rng, captions, lengths, idx, valid, style):
            def body(carry, xs):
                dec, opt_state, rng = carry
                bidx, bvalid = xs
                rng, k = jax.random.split(rng)
                caps = jnp.take(captions, bidx, axis=0) * bvalid[:, None]
                lens = jnp.where(bvalid, jnp.take(lengths, bidx, axis=0), 0)
                if mesh is not None:
                    caps = jax.lax.with_sharding_constraint(caps, bsh)
                dec, opt_state, loss = step(dec, opt_state, caps, lens,
                                            bvalid, style, k)
                return (dec, opt_state, rng), loss

            (dec, opt_state, rng), losses = jax.lax.scan(
                body, (dec, opt_state, rng), (idx, valid))
            return dec, opt_state, rng, losses

        fn = jax.jit(epoch)
        self._sepoch_cache[emo] = fn
        return fn

    def train(self, data_loader, style_loaders: Dict[str, object],
              num_epochs: Optional[int] = None) -> None:
        from icee_tpu.data.device import DeviceCaptionData

        num_epochs = num_epochs or self.tcfg.num_epochs
        for epoch in range(num_epochs):
            self._run_train(data_loader, 0, self.tcfg.log_step, "FAC")
            for emo, loader in style_loaders.items():
                sid = mode_id(emo)
                if isinstance(loader, DeviceCaptionData):
                    idx, valid = loader.epoch_indices()
                    fn = self._style_epoch_fn(emo)
                    (self.dec, self.style_opt_states[emo], self.rng,
                     _losses) = fn(
                        self.dec, self.style_opt_states[emo], self.rng,
                        loader.captions, loader.lengths, jnp.asarray(idx),
                        jnp.asarray(valid), jnp.asarray(sid))
                    continue
                step = self.style_steps[emo]
                for batch in loader:
                    caps, lens, smask = self._to_device(
                        batch.captions, batch.lengths, batch.sample_mask)
                    self.dec, self.style_opt_states[emo], loss = step(
                        self.dec, self.style_opt_states[emo],
                        caps, lens, smask, jnp.asarray(sid),
                        self._next_rng())
            self.save(epoch, is_best=False, mode_tag="PAPER")


class Seq2SeqTrainer:
    """T6 (``seq2seq/train.py``): factual autoencode pass + per-emotion
    decoder passes.  Reference quirk preserved: the emotion pass feeds the
    *factual* caption as both source and target
    (``seq2seq/train.py:316-317``), so loaders only need (image, src)."""

    def __init__(self, cfg: Seq2SeqConfig, tcfg: TrainConfig, vocab, params,
                 head, log_path: Optional[str] = None, mesh=None):
        self.cfg, self.tcfg, self.vocab = cfg, tcfg, vocab
        self.params, self.head = params, head
        self.log_path = log_path
        self.mesh = mesh
        if mesh is not None:
            # replicate everything (the seq2seq decoders are small); the
            # batch axis shards over "data" in _to_device and GSPMD inserts
            # the gradient psum
            from icee_tpu.parallel import train as ptrain

            self.params = ptrain.place_replicated(self.params, mesh)
            self.head = ptrain.place_replicated(self.head, mesh)
        self.rng = jax.random.PRNGKey(tcfg.seed)
        self.optimizer = optim.make_adam(tcfg.lr_caption, tcfg)
        self.emotion_optimizer = optim.make_adam(tcfg.lr_language, tcfg)
        (self.factual_step, self.emotion_step, self.val_factual,
         self.val_emotion) = make_seq2seq_steps(
            cfg, tcfg, self.optimizer, self.emotion_optimizer)
        self.opt_state = self.optimizer.init((params["encoder"], head))
        self.emotion_opt_state = self.emotion_optimizer.init(params["decoders"])

    def _next_rng(self):
        self.rng, k = jax.random.split(self.rng)
        return k

    # -- device-resident whole-epoch programs ------------------------------

    def _gather_batch(self, images, captions, lengths, bidx, b_img, bvalid):
        """Gather one minibatch from the pinned split inside a jitted epoch
        (padded rows zeroed exactly like the host loader's batch padding —
        the encoder head's BatchNorm sees every row).  ``b_img`` holds the
        unique-image gather rows (``DeviceCaptionData.image_rows``)."""
        from icee_tpu.data.device import gather_rows

        imgs = gather_rows(images, b_img).astype(jnp.float32)
        imgs = imgs * bvalid[:, None].astype(imgs.dtype)
        caps = jnp.take(captions, bidx, axis=0) * bvalid[:, None]
        lens = jnp.where(bvalid, jnp.take(lengths, bidx, axis=0), 0)
        if self.mesh is not None:
            from icee_tpu.parallel.mesh import batch_sharding

            bsh = batch_sharding(self.mesh)
            imgs = jax.lax.with_sharding_constraint(imgs, bsh)
            caps = jax.lax.with_sharding_constraint(caps, bsh)
        return imgs, caps, lens

    def _device_epoch_fns(self):
        """Jitted whole-epoch programs for device-resident splits: the
        factual autoencode pass, the per-emotion pass (dst=src overwrite
        inside the scan), and both validation passes — each epoch is ONE
        dispatch (``data/device.py``; same RNG split order as the host
        loops, so parameters match bit-for-bit)."""
        if hasattr(self, "_depoch_fns"):
            return self._depoch_fns
        fac_step, emo_step = self.factual_step, self.emotion_step
        val_fac, val_emo = self.val_factual, self.val_emotion
        gather = self._gather_batch

        def fac_epoch(params, head, opt_state, rng, images, captions,
                      lengths, idx, img_rows, valid):
            def body(carry, xs):
                params, head, opt_state, rng = carry
                bidx, b_img, bvalid = xs
                rng, k = jax.random.split(rng)
                imgs, caps, lens = gather(images, captions, lengths,
                                          bidx, b_img, bvalid)
                params, head, opt_state, loss = fac_step(
                    params, head, opt_state, imgs, caps, lens, bvalid, k)
                return (params, head, opt_state, rng), (loss, lens.sum())

            (params, head, opt_state, rng), (losses, ntoks) = jax.lax.scan(
                body, (params, head, opt_state, rng), (idx, img_rows, valid))
            return params, head, opt_state, rng, losses, ntoks

        def emo_epoch(params, head, opt_state, rng, images, captions,
                      lengths, idx, img_rows, valid, eid):
            def body(carry, xs):
                params, opt_state, rng = carry
                bidx, b_img, bvalid = xs
                rng, k = jax.random.split(rng)
                imgs, caps, lens = gather(images, captions, lengths,
                                          bidx, b_img, bvalid)
                # dst = src (reference overwrite, seq2seq/train.py:316-317)
                params, opt_state, loss = emo_step(
                    params, head, opt_state, imgs, caps, lens, caps, lens,
                    bvalid, eid, k)
                return (params, opt_state, rng), (loss, lens.sum())

            (params, opt_state, rng), (losses, ntoks) = jax.lax.scan(
                body, (params, opt_state, rng), (idx, img_rows, valid))
            return params, opt_state, rng, losses, ntoks

        def val_fac_epoch(params, head, images, captions, lengths, idx,
                          img_rows, valid):
            def body(_, xs):
                bidx, b_img, bvalid = xs
                imgs, caps, lens = gather(images, captions, lengths,
                                          bidx, b_img, bvalid)
                loss, top5, _ = val_fac(params, head, imgs, caps, lens,
                                        bvalid)
                return 0, (loss, top5, lens.sum())

            _, out = jax.lax.scan(body, 0, (idx, img_rows, valid))
            return out

        def val_emo_epoch(params, head, images, captions, lengths, idx,
                          img_rows, valid, eid):
            def body(_, xs):
                bidx, b_img, bvalid = xs
                imgs, caps, lens = gather(images, captions, lengths,
                                          bidx, b_img, bvalid)
                loss, top5, _ = val_emo(params, head, imgs, caps, lens,
                                        caps, lens, bvalid, eid)
                return 0, (loss, top5,
                           jnp.clip(lens - 1, 0, None).sum())

            _, out = jax.lax.scan(body, 0, (idx, img_rows, valid))
            return out

        self._depoch_fns = (jax.jit(fac_epoch), jax.jit(emo_epoch),
                            jax.jit(val_fac_epoch), jax.jit(val_emo_epoch))
        return self._depoch_fns

    def train(self, data_loader, emotion_loaders: Dict[str, object],
              num_epochs: Optional[int] = None,
              val_loader=None, val_emotion_loaders: Optional[Dict] = None
              ) -> None:
        from icee_tpu.data.device import DeviceCaptionData

        num_epochs = num_epochs or self.tcfg.num_epochs
        for epoch in range(num_epochs):
            losses = AverageMeter()
            if isinstance(data_loader, DeviceCaptionData):
                idx, valid = data_loader.epoch_indices()
                fac_epoch = self._device_epoch_fns()[0]
                (self.params, self.head, self.opt_state, self.rng,
                 ep_losses, ep_ntoks) = fac_epoch(
                    self.params, self.head, self.opt_state, self.rng,
                    data_loader.images, data_loader.captions,
                    data_loader.lengths, jnp.asarray(idx),
                    jnp.asarray(data_loader.image_rows(idx)),
                    jnp.asarray(valid))
                for ls, nt in zip(np.asarray(ep_losses, np.float64),
                                  np.asarray(ep_ntoks, np.float64)):
                    losses.update(float(ls), int(nt))
                data_loader_batches = ()
            else:
                data_loader_batches = data_loader
            for batch in data_loader_batches:
                imgs, caps, lens, smask = _to_device(
                    self.mesh, batch.images, batch.captions, batch.lengths,
                    batch.sample_mask)
                self.params, self.head, self.opt_state, loss = \
                    self.factual_step(
                        self.params, self.head, self.opt_state,
                        imgs, caps, lens, smask, self._next_rng())
                losses.update(float(loss), int(batch.lengths.sum()))
            _log(self.log_path,
                 f"Epoch [{epoch}/{num_epochs}], [FAC], "
                 f"Loss {losses.avg:.4f}")
            if val_loader is not None:
                vl, vt = self.validate_factual(val_loader)
                _log(self.log_path,
                     f"\tVal Loss: {vl:.4f} | Perplexity "
                     f"{perplexity(vl):.4f} | Top-5 {vt:.3f}")
            for emo, loader in emotion_loaders.items():
                eid = mode_id(emo) - 1
                e_losses = AverageMeter()
                if isinstance(loader, DeviceCaptionData):
                    idx, valid = loader.epoch_indices()
                    emo_epoch = self._device_epoch_fns()[1]
                    (self.params, self.emotion_opt_state, self.rng,
                     ep_losses, ep_ntoks) = emo_epoch(
                        self.params, self.head, self.emotion_opt_state,
                        self.rng, loader.images, loader.captions,
                        loader.lengths, jnp.asarray(idx),
                        jnp.asarray(loader.image_rows(idx)),
                        jnp.asarray(valid), jnp.asarray(eid))
                    for ls, nt in zip(np.asarray(ep_losses, np.float64),
                                      np.asarray(ep_ntoks, np.float64)):
                        e_losses.update(float(ls), int(nt))
                    loader = ()
                for batch in loader:
                    imgs, caps, lens, smask = _to_device(
                        self.mesh, batch.images, batch.captions,
                        batch.lengths, batch.sample_mask)
                    # dst = src (reference overwrite, seq2seq/train.py:316-317)
                    self.params, self.emotion_opt_state, loss = \
                        self.emotion_step(
                            self.params, self.head, self.emotion_opt_state,
                            imgs, caps, lens, caps, lens,
                            smask, jnp.asarray(eid),
                            self._next_rng())
                    e_losses.update(float(loss), int(batch.lengths.sum()))
                _log(self.log_path,
                     f"Epoch [{epoch}/{num_epochs}], "
                     f"[{emo[:3].upper()}], Loss {e_losses.avg:.4f}")
                if val_emotion_loaders and emo in val_emotion_loaders:
                    vl, vt = self.validate_emotion(
                        val_emotion_loaders[emo], eid)
                    _log(self.log_path,
                         f"\tVal Loss: {vl:.4f} | Top-5 {vt:.3f}")

    def validate_factual(self, loader):
        """seq2seq ``val_factual`` (``seq2seq/train.py:262-299``): teacher-
        forcing off, token-mean loss + top-5."""
        from icee_tpu.data.device import DeviceCaptionData

        losses, top5s = AverageMeter(), AverageMeter()
        if isinstance(loader, DeviceCaptionData):
            idx, valid = loader.epoch_indices()
            val_epoch = self._device_epoch_fns()[2]
            ep_losses, ep_top5s, ep_ntoks = val_epoch(
                self.params, self.head, loader.images, loader.captions,
                loader.lengths, jnp.asarray(idx),
                jnp.asarray(loader.image_rows(idx)), jnp.asarray(valid))
            for ls, t5, nt in zip(np.asarray(ep_losses, np.float64),
                                  np.asarray(ep_top5s, np.float64),
                                  np.asarray(ep_ntoks, np.float64)):
                losses.update(float(ls), int(nt))
                top5s.update(float(t5), int(nt))
            return losses.avg, top5s.avg
        for batch in loader:
            imgs, caps, lens, smask = _to_device(
                self.mesh, batch.images, batch.captions, batch.lengths,
                batch.sample_mask)
            loss, top5, _ = self.val_factual(
                self.params, self.head, imgs, caps, lens, smask)
            n = int(batch.lengths.sum())
            losses.update(float(loss), n)
            top5s.update(float(top5), n)
        return losses.avg, top5s.avg

    def validate_emotion(self, loader, emotion_id: int):
        """seq2seq ``val_emotion`` (``seq2seq/train.py:303-345``), with the
        dst=src overwrite preserved."""
        from icee_tpu.data.device import DeviceCaptionData

        losses, top5s = AverageMeter(), AverageMeter()
        if isinstance(loader, DeviceCaptionData):
            idx, valid = loader.epoch_indices()
            val_epoch = self._device_epoch_fns()[3]
            ep_losses, ep_top5s, ep_ntoks = val_epoch(
                self.params, self.head, loader.images, loader.captions,
                loader.lengths, jnp.asarray(idx),
                jnp.asarray(loader.image_rows(idx)), jnp.asarray(valid),
                jnp.asarray(emotion_id))
            for ls, t5, nt in zip(np.asarray(ep_losses, np.float64),
                                  np.asarray(ep_top5s, np.float64),
                                  np.asarray(ep_ntoks, np.float64)):
                losses.update(float(ls), max(int(nt), 1))
                top5s.update(float(t5), max(int(nt), 1))
            return losses.avg, top5s.avg
        for batch in loader:
            imgs, caps, lens, smask = _to_device(
                self.mesh, batch.images, batch.captions, batch.lengths,
                batch.sample_mask)
            loss, top5, _ = self.val_emotion(
                self.params, self.head, imgs,
                caps, lens, caps, lens, smask, jnp.asarray(emotion_id))
            n = int((batch.lengths - 1).clip(min=0).sum())
            losses.update(float(loss), max(n, 1))
            top5s.update(float(top5), max(n, 1))
        return losses.avg, top5s.avg
