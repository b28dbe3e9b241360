"""Host input pipeline: fixed-shape masked batches with prefetch.

Replacement for the reference's ``DataLoader`` + ``collate_fn``
stack (``stylenet/data_loader.py:116-197``): instead of sorting each batch by
length and packing (a CUDA-era trick for ``pack_padded_sequence``), every
batch is padded to a *static* ``(batch_size, max_len)`` shape with explicit
``lengths`` and masks, so the whole training step compiles once under ``jit``
and the time loop is a ``lax.scan`` over a fixed number of steps.

Loss/metric normalization stays bit-compatible with packed semantics: the
reference's ``CrossEntropyLoss`` averages over *tokens* of the packed batch,
which equals a mask-weighted mean over the padded layout (see
``icee_tpu.train.losses``).

Parallelism: a background thread pool decodes/loads examples and a bounded
queue prefetches device-ready batches — the host-side analogue of the
reference's ``num_workers=4`` loader processes, without the
``file_system``-sharing workaround (``train_multitask.py:23-24``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class CaptionBatch:
    """Device-ready batch. ``references`` stays host-side (ragged, BLEU only)."""

    images: Optional[np.ndarray]      # (B, H, W, 3) uint8/float or features
    captions: np.ndarray              # (B, L) int32, 0-padded
    lengths: np.ndarray               # (B,) int32 — includes <start>/<end>
    sample_mask: np.ndarray           # (B,) bool — False for batch padding
    references: Optional[List[List[List[int]]]] = None

    @property
    def batch_size(self) -> int:
        return self.captions.shape[0]


def pad_captions(
    caption_ids: Sequence[Sequence[int]], max_len: int, pad_id: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of id lists to ``(N, max_len)``; silently truncates to
    ``max_len`` (the reference caps sequences at ``max_seq_length`` instead of
    ever seeing longer ones; Flickr8k captions fit comfortably)."""
    n = len(caption_ids)
    out = np.full((n, max_len), pad_id, dtype=np.int32)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, ids in enumerate(caption_ids):
        L = min(len(ids), max_len)
        out[i, :L] = np.asarray(ids[:L], dtype=np.int32)
        lengths[i] = L
    return out, lengths


def make_batch(
    caption_ids: Sequence[Sequence[int]],
    max_len: int,
    batch_size: int,
    images: Optional[np.ndarray] = None,
    references: Optional[List[List[List[int]]]] = None,
    pad_id: int = 0,
) -> CaptionBatch:
    """Build one fixed-size batch, padding the trailing partial batch.

    Padded samples carry ``lengths=0`` and ``sample_mask=False`` so they
    contribute nothing to the masked loss.
    """
    n = len(caption_ids)
    if n > batch_size:
        raise ValueError(f"{n} examples > batch_size {batch_size}")
    captions, lengths = pad_captions(caption_ids, max_len, pad_id)
    if n < batch_size:
        captions = np.concatenate(
            [captions, np.full((batch_size - n, max_len), pad_id, np.int32)]
        )
        lengths = np.concatenate([lengths, np.zeros((batch_size - n,), np.int32)])
        if images is not None:
            pad_img = np.zeros((batch_size - n,) + images.shape[1:], images.dtype)
            images = np.concatenate([images, pad_img])
    mask = np.arange(batch_size) < n
    return CaptionBatch(
        images=images,
        captions=captions,
        lengths=lengths,
        sample_mask=mask,
        references=references,
    )


class BatchLoader:
    """Epoch iterator over an example list with shuffle + threaded prefetch.

    ``example_fn(indices) -> CaptionBatch`` materializes a batch from dataset
    indices (decoding images on the host).  Shuffling uses a seeded
    ``np.random.Generator`` so epochs are reproducible.
    """

    def __init__(
        self,
        num_examples: int,
        batch_size: int,
        example_fn: Callable[[np.ndarray], CaptionBatch],
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        num_threads: int = 4,
    ) -> None:
        self.num_examples = num_examples
        self.batch_size = batch_size
        self.example_fn = example_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_threads = num_threads
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_examples // self.batch_size
        return -(-self.num_examples // self.batch_size)

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(self.num_examples)
        if self.shuffle:
            self._rng.shuffle(idx)
        batches = [
            idx[i : i + self.batch_size]
            for i in range(0, self.num_examples, self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[CaptionBatch]:
        self._epoch += 1
        batches = self._index_batches()
        if self.prefetch <= 0:
            for b in batches:
                yield self.example_fn(b)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer() -> None:
            try:
                for b in batches:
                    q.put(self.example_fn(b))
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()


def caption_dataset_loader(
    examples,
    batch_size: int,
    max_len: int,
    image_provider: Optional[Callable[[str], np.ndarray]] = None,
    shuffle: bool = True,
    seed: int = 0,
    prefetch: int = 2,
) -> BatchLoader:
    """Loader over :class:`icee_tpu.data.captions.CaptionExample` lists.

    Captions are encoded ONCE into flat ragged storage; per-batch padding is
    the threaded C++ batcher (``icee_tpu.native``, NumPy fallback) — the
    reference instead re-tokenizes text in DataLoader workers every epoch.
    """
    from icee_tpu.native import RaggedCaptions

    rag = RaggedCaptions([e.caption_ids for e in examples])

    def example_fn(indices: np.ndarray) -> CaptionBatch:
        exs = [examples[i] for i in indices]
        images = None
        if image_provider is not None:
            images = np.stack([image_provider(e.image) for e in exs])
        captions, lengths = rag.batch(indices, max_len=max_len)
        n = len(indices)
        if n < batch_size:
            captions = np.concatenate(
                [captions, np.zeros((batch_size - n, max_len), np.int32)])
            lengths = np.concatenate(
                [lengths, np.zeros((batch_size - n,), np.int32)])
            if images is not None:
                images = np.concatenate(
                    [images,
                     np.zeros((batch_size - n,) + images.shape[1:],
                              images.dtype)])
        return CaptionBatch(
            images=images,
            captions=captions,
            lengths=lengths,
            sample_mask=np.arange(batch_size) < n,
            references=[e.all_caption_ids for e in exs],
        )

    return BatchLoader(
        num_examples=len(examples),
        batch_size=batch_size,
        example_fn=example_fn,
        shuffle=shuffle,
        seed=seed,
        prefetch=prefetch,
    )


def styled_caption_loader(
    caption_ids,
    batch_size: int,
    max_len: int,
    shuffle: bool = True,
    seed: int = 0,
    prefetch: int = 2,
) -> BatchLoader:
    """Loader over text-only styled corpora (the reference's
    ``get_style_loader``, ``data_loader.py:183-197``): batches carry captions
    + lengths only, no images."""
    from icee_tpu.native import RaggedCaptions

    rag = RaggedCaptions(caption_ids)

    def example_fn(indices: np.ndarray) -> CaptionBatch:
        captions, lengths = rag.batch(indices, max_len=max_len)
        n = len(indices)
        if n < batch_size:
            captions = np.concatenate(
                [captions, np.zeros((batch_size - n, max_len), np.int32)])
            lengths = np.concatenate(
                [lengths, np.zeros((batch_size - n,), np.int32)])
        return CaptionBatch(
            images=None,
            captions=captions,
            lengths=lengths,
            sample_mask=np.arange(batch_size) < n,
        )

    return BatchLoader(
        num_examples=len(caption_ids),
        batch_size=batch_size,
        example_fn=example_fn,
        shuffle=shuffle,
        seed=seed,
        prefetch=prefetch,
    )
