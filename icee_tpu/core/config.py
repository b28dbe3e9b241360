"""Typed configuration objects for every workload.

The reference drives each experiment with a per-script ``argparse`` block of
hard-coded defaults (e.g. ``stylenet/train_multitask.py:560-634``).  Here the
same knobs live in frozen dataclasses shared by the CLIs, the trainers and the
serving app, so a single config object fully describes a run.

Default values mirror the reference defaults:

- model sizes: ``embed 300 / hidden 512 / factored 512 / dropout 0.5``
  (``stylenet/train_multitask.py:621-625``),
- optimization: Adam ``lr 2e-4`` (factual) / ``5e-4`` (emotion), grad value
  clip ``0.5`` (``:619,631-633``), LR x0.8 on 4-epoch plateau, early stop at
  10 (``:183-190``),
- decode: beam ``k=5``, ``max_seq_length=40`` (``stylenet/model.py:41,202``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Style modes, in the reference's fixed order.  ``factual`` must be index 0 so
# that emotion-only parameter groups are the trailing slices of the stacked
# style tensors (see models/factored_lstm.py).
MODE_FACTUAL = "factual"
MODE_HAPPY = "happy"
MODE_SAD = "sad"
MODE_ANGRY = "angry"
MODES: Tuple[str, ...] = (MODE_FACTUAL, MODE_HAPPY, MODE_SAD, MODE_ANGRY)
# Emotion-only tags in the order the reference enumerates them
# (``train_multitask.py:139``).
EMOTIONS: Tuple[str, ...] = (MODE_HAPPY, MODE_SAD, MODE_ANGRY)


def mode_id(mode: str) -> int:
    """Integer id of a style mode (static index into stacked style weights)."""
    try:
        return MODES.index(mode)
    except ValueError:
        raise ValueError(f"mode name wrong! got {mode!r}, want one of {MODES}")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """CNN encoder (reference ``EncoderCNN``, ``stylenet/model.py:11-27`` and
    spatial variant ``stylenet/model_att.py:11-29``)."""

    embed_size: int = 300
    feature_size: int = 2048          # ResNet-152 final channel count
    spatial: bool = False             # True -> 14x14 grid features (attention)
    encoded_image_size: int = 14      # adaptive-pool grid for spatial encoder
    bn_momentum: float = 0.01         # BatchNorm1d(momentum=0.01) on the head
    image_size: int = 224             # crop fed to the CNN
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """LSTM decoder families (NIC ``nic/model.py:30-207``, StyleNet
    FactoredLSTM ``stylenet/model.py:30-294``)."""

    vocab_size: int = 0               # filled from the built vocabulary
    embed_size: int = 300
    hidden_size: int = 512
    factored_size: int = 512          # FactoredLSTM only
    num_layers: int = 1
    num_styles: int = 4               # factual + happy + sad + angry
    feature_size: int = 2048
    dropout: float = 0.5
    max_seq_length: int = 40
    # Input size of the recurrent cell; attention decoders consume
    # [word_emb ; gated context] (stylenet/model_att.py:113-137).
    factored: bool = True             # False -> plain LSTM cell (NIC)

    @property
    def input_size(self) -> int:
        return self.embed_size


@dataclasses.dataclass(frozen=True)
class AttentionDecoderConfig(DecoderConfig):
    """Attention variants (``stylenet/model_att.py:73-426``,
    ``nic/model_att.py:73-306``)."""

    attention_size: int = 512

    @property
    def input_size(self) -> int:
        # [word_emb ; gated 2048-dim context] per step
        return self.embed_size + self.feature_size


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    """Seq2seq style transfer (``seq2seq/model.py:220-301``)."""

    vocab_size: int = 0
    embed_size: int = 300
    hidden_size: int = 512
    num_layers: int = 1
    dropout: float = 0.22
    max_seq_length: int = 40
    feature_size: int = 2048


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training regime (multitask / transfer / seq2seq)."""

    mode: str = MODE_HAPPY            # which emotion track to co-train
    num_epochs: int = 120
    caption_batch_size: int = 64
    language_batch_size: int = 96
    lr_caption: float = 2e-4
    lr_language: float = 5e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip: float = 0.5            # elementwise clamp, utils.py:51-60
    teacher_forcing_ratio: float = 0.8
    lr_decay_factor: float = 0.8      # x0.8 every 4 plateau epochs
    lr_decay_patience: int = 4
    early_stop_patience: int = 10
    # Fixed padded caption length: max_seq_length + <start> + <end>.
    max_caption_len: int = 42
    seed: int = 0
    log_step: int = 50
    log_step_emotion: int = 5
    # doubly-stochastic attention regularizer weight
    # (train_multitask_att.py:322-323); only used by attention trainers.
    alpha_c: float = 1.0
    # crop/resize sizes (train_multitask.py:63-69)
    resize_size: int = 336
    crop_size: int = 224
    # Compute the training CE in time chunks directly from the decoder's
    # hidden states (ops/chunked_loss.py) — the (B, T, V) logits never
    # materialize in device memory.  Numerically equal to the materialized
    # loss (grads to <=2e-7); None (default) = the backend's choice
    # (core/backend.py).
    chunked_ce: Optional[bool] = None
    # Mid-epoch preemption safety for device-resident training (beyond the
    # reference, whose host loop can only resume at epoch boundaries,
    # train_multitask.py:169-177): when > 0, each whole-epoch device scan
    # of the captioner trainers (Multitask / Transfer / factual-only) runs
    # as ceil(n_batches / progress_chunk) dispatches of ``progress_chunk``
    # batch rows, and a progress checkpoint (params, both optimizer states,
    # the in-scan RNG carry, epoch/pass/row and the partial loss trace) is
    # written after every chunk (checkpoint/progress.py).  A killed run
    # resumes INSIDE the epoch, bit-identically
    # (tests/test_progress_resume.py).  0 (default) = whole-epoch single
    # dispatch.
    progress_chunk: int = 0
