"""Device-resident captioner dataset — whole-epoch training programs.

The reference's only "device-resident" data path is the SentiCap family's
Theano shared arrays (``senticap/mrnn/mrnn.py:581-596``, SURVEY §2.5
P-resident row); the PyTorch captioners re-feed every batch from host
DataLoader workers (``stylenet/train_multitask.py:364-408``).  Once the
step itself is fast the per-batch host dispatch (and the host loop's
``float(loss)`` sync every batch) dominates the epoch — so this formulation
pins the whole split on device and runs the ENTIRE epoch as one jitted
``lax.scan`` over shuffled batch-index rows: one dispatch per epoch.

:class:`DeviceCaptionData` packs a ``CaptionExample`` list (features via the
same ``image_provider`` the host loader uses) into device arrays and
reproduces :class:`icee_tpu.data.pipeline.BatchLoader`'s epoch composition
exactly — same seeded ``np.random.default_rng`` shuffle, same trailing
partial batch — so a device epoch and a host-loader epoch visit identical
batches and (with matching RNG splits in the trainer) produce bit-identical
parameters.

Memory: features are stored per UNIQUE image, not per example — Flickr-style
splits carry 5 reference captions per image (``FlickrDataset`` D3), so the
(N_examples, ...) feature array would be 5x larger than the data.  Each
example keeps a host-side ``image_index`` into the unique-feature array and
the epoch programs gather ``images[image_index[bidx]]`` — bit-identical to
the undeduplicated gather.  Pooled features for the whole Flickr8k train
split are ~13 MB; spatial attention features (U, 196, 2048) at ~1.6 MB per
unique image are gated by ``fits_device`` at the call site (pass the
UNIQUE-image count).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from icee_tpu.data.pipeline import pad_captions


def gather_rows(images, rows):
    """Copy-free batch gather ``images[rows]`` for jitted epoch programs.

    ``jnp.take(images, rows, axis=0)`` may lower through a gather path
    that materializes a full COPY of the operand — for a pinned multi-GiB
    spatial split that copy alone can exhaust device memory.  A vmapped
    ``lax.dynamic_slice_in_dim`` compiles to per-row slices that read the
    operand IN PLACE and returns bit-identical values for in-bounds rows
    (both forms clamp out-of-bounds starts); on the GPU the copy is still
    to be measured (``compiled.memory_analysis()``).  Inside a ``lax.scan`` the
    while-loop constant threading still copies the operand once — the
    per-batch pinned tier (``DeviceCaptionData.per_batch``) exists for
    splits where that copy does not fit.
    """
    import jax

    def one(r):
        return jax.lax.dynamic_slice_in_dim(images, r, 1, axis=0)[0]

    return jax.vmap(one)(rows)


@dataclasses.dataclass
class DeviceCaptionData:
    """A caption split pinned on device + the host-side epoch index maker.

    ``images``/``captions``/``lengths`` are device arrays of the FULL split;
    per-epoch shuffling happens on the host over int32 indices only (a
    (num_batches, batch_size) transfer, bytes not megabytes).
    """

    images: object                # (U, ...) f32 device array (features of
    #                               the UNIQUE images; U <= N)
    captions: object              # (N, T) int32 device array
    lengths: object               # (N,) int32 device array
    num_examples: int
    batch_size: int
    shuffle: bool = True
    seed: int = 0
    # host-side per-example reference caption lists (all 5 refs per image,
    # ``FlickrDataset`` D3) — consumed by the BLEU side of the device val
    # epoch, never shipped to the device
    references: Optional[List[List[List[int]]]] = None
    # host-side (N,) example -> unique-image row map (None for text-only
    # styled corpora); translated per batch by :meth:`image_rows` so the
    # device never holds the map
    image_index: Optional[np.ndarray] = None
    # pinned-per-batch tier: the whole-epoch lax.scan program
    # threads the pinned feature array through the XLA while-loop state,
    # which COPIES it — one-dispatch epochs need ~2x the feature bytes of
    # HBM.  ``per_batch=True`` keeps features pinned but dispatches one
    # jitted step per batch (no scan -> no copy; ``pin_plan`` selects the
    # tier, ``gather_rows`` keeps the per-dispatch gather copy-free).
    per_batch: bool = False
    _rng: np.random.Generator = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def __len__(self) -> int:
        return -(-self.num_examples // self.batch_size)

    def epoch_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> ((nb, B) int32 gather indices, (nb, B) bool sample mask).

        Identical composition to ``BatchLoader._index_batches`` (same seeded
        generator, same trailing partial batch); padding rows gather example
        0 with ``valid=False`` so the masked loss ignores them.
        """
        idx = np.arange(self.num_examples)
        if self.shuffle:
            self._rng.shuffle(idx)
        nb = len(self)
        out = np.zeros((nb, self.batch_size), np.int32)
        valid = np.zeros((nb, self.batch_size), bool)
        for b in range(nb):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            out[b, : len(chunk)] = chunk
            valid[b, : len(chunk)] = True
        return out, valid

    def image_rows(self, idx: np.ndarray) -> np.ndarray:
        """Translate example-index batch rows (``epoch_indices`` output) to
        unique-image gather rows for the ``images`` array."""
        if self.image_index is None:
            return np.asarray(idx, np.int32)
        return self.image_index[idx].astype(np.int32)


@dataclasses.dataclass
class StreamedCaptionData(DeviceCaptionData):
    """A split whose features exceed the pin budget (`fits_device`):
    captions/lengths live on device (int32, always tiny) but features stay
    HOST-side and stream per chunk of batch rows.

    The epoch composition (seeded shuffle, trailing partial batch) is
    IDENTICAL to :class:`DeviceCaptionData`; the trainer runs the same
    whole-epoch scan program per chunk — ``rows_per_chunk`` batch rows per
    dispatch — with a compact per-chunk feature array (the chunk's unique
    images, deduplicated and padded to the fixed ``capacity`` so every chunk
    reuses ONE compiled program).  Host ``np.take`` + async ``device_put``
    of chunk c+1 overlap the device compute of chunk c (double-buffered, and
    the epoch scan's loop state copies the active buffer once per dispatch,
    so ``capacity`` should be sized to a THIRD of the device feature
    budget — ``from_examples_streamed`` does).  Note the PIN side of the
    gate budgets ~2x its feature bytes: XLA may make one whole-array copy
    of the pinned features inside the one-dispatch epoch program.
    Parameters
    after a streamed epoch are numerically equivalent to the pinned device
    epoch and the host ``BatchLoader`` loop (same batches, same RNG split
    order; tested to 1e-6 — chunked dispatch boundaries change XLA fusion,
    so bit-exactness vs the single-dispatch epoch is not claimed, while
    kill/resume WITHIN the streamed path is bit-exact).

    This replaces the host-loader fallback for splits larger than the
    budget — e.g. the full Flickr8k spatial-attention train split (~6k
    unique images x 1.6 MB), where the per-batch host path pays a dispatch
    twice per batch and re-transfers duplicated features.
    """

    host_features: Optional[np.ndarray] = None   # (U, ...) f32 HOST array
    capacity: int = 0                            # feature rows per chunk buf
    mesh: object = None

    def __post_init__(self):
        super().__post_init__()
        assert self.images is None, "streamed data keeps features on host"
        self.capacity = max(self.capacity, self.batch_size)

    @property
    def rows_per_chunk(self) -> int:
        """Batch rows per dispatch — conservative (no-dedup) bound so any
        chunk's unique features fit ``capacity``."""
        return max(self.capacity // self.batch_size, 1)

    def chunk_features(
        self, img_rows: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Compact one chunk's gather plan.

        ``img_rows``: (rows, B) unique-image gather rows (``image_rows``
        output for the chunk's slice).  Returns ``(features, remap)`` where
        ``features`` is the (capacity, ...) host array holding the chunk's
        deduplicated features in rows ``[0, n_uniq)`` (padding rows repeat
        row 0 — never gathered, since ``remap`` only addresses real rows)
        and ``remap`` is (rows, B) int32 into it.
        """
        flat = np.asarray(img_rows).ravel()
        uniq, inv = np.unique(flat, return_inverse=True)
        if len(uniq) > self.capacity:
            raise ValueError(
                f"chunk needs {len(uniq)} unique features > capacity "
                f"{self.capacity} (rows_per_chunk is miscomputed)")
        take = np.zeros(self.capacity, np.int64)
        take[: len(uniq)] = uniq
        feats = self.host_features[take]
        remap = inv.astype(np.int32).reshape(np.asarray(img_rows).shape)
        return feats, remap

    def put_features(self, feats: np.ndarray):
        """Async host->device transfer of one chunk buffer (replicated
        across the mesh when training data-parallel)."""
        import jax
        import jax.numpy as jnp

        if self.mesh is not None:
            from icee_tpu.parallel.mesh import replicated

            return jax.device_put(feats, replicated(self.mesh))
        return jnp.asarray(feats)

    def sample_feature(self, unique_row: int):
        """One image's feature row, placed like the pinned path would place
        it (mesh-replicated when training data-parallel, ADVICE r4 — the
        jitted sample_fn must see the same sharding as a pinned slice)."""
        return self.put_features(
            self.host_features[unique_row:unique_row + 1])


def from_examples(
    examples: List,
    batch_size: int,
    max_len: int,
    image_provider: Callable[[str], np.ndarray],
    shuffle: bool = True,
    seed: int = 0,
    mesh=None,
    per_batch: bool = False,
    feature_dtype=None,
) -> DeviceCaptionData:
    """Pack ``CaptionExample``s (+ cached features) into device arrays.

    Mirrors ``caption_dataset_loader``'s per-example encoding (captions were
    tokenized once at dataset build; features come from the same memoized
    provider).  With a mesh the arrays are replicated across it so the
    whole-epoch jit can reshard gathered batches over the data axis without
    cross-device gathers.  ``per_batch=True`` selects the pinned-per-batch
    tier (see :class:`DeviceCaptionData` / :func:`pin_plan`).

    ``feature_dtype`` (e.g. ``ml_dtypes.bfloat16``) stores the pinned
    features in a narrower dtype — halving every tier's HBM wall — and the
    epoch programs cast each gathered batch back to f32 before the step,
    so the only numerical difference is the one-time storage rounding
    (exact for features already representable in the storage dtype).
    """
    import jax
    import jax.numpy as jnp

    captions, lengths = pad_captions([e.caption_ids for e in examples],
                                     max_len)
    images, image_index = _pack_unique(examples, image_provider)
    if feature_dtype is not None:
        images = images.astype(feature_dtype)
    if mesh is not None:
        from icee_tpu.parallel.mesh import replicated

        sh = replicated(mesh)
        put = lambda a: jax.device_put(a, sh)  # noqa: E731
    else:
        put = jnp.asarray
    return DeviceCaptionData(
        images=put(images),
        captions=put(captions),
        lengths=put(lengths),
        num_examples=len(examples),
        batch_size=batch_size,
        shuffle=shuffle,
        seed=seed,
        references=[e.all_caption_ids for e in examples],
        image_index=image_index,
        per_batch=per_batch,
    )


def _pack_unique(examples, image_provider):
    """Features per UNIQUE image + the (N,) example -> unique-row map
    (5-ref splits would otherwise hold 5 copies of every feature)."""
    uniq, order = {}, []
    for e in examples:
        if e.image not in uniq:
            uniq[e.image] = len(order)
            order.append(e.image)
    image_index = np.asarray([uniq[e.image] for e in examples], np.int32)
    images = np.stack([image_provider(n) for n in order]).astype(np.float32)
    return images, image_index


def from_examples_streamed(
    examples: List,
    batch_size: int,
    max_len: int,
    image_provider: Callable[[str], np.ndarray],
    shuffle: bool = True,
    seed: int = 0,
    mesh=None,
    budget_bytes: int = 4 << 30,
    feature_dtype=None,
) -> StreamedCaptionData:
    """Pack a split that FAILS ``fits_device`` for chunk-streamed
    whole-epoch training: captions/lengths pinned on device, features kept
    host-side with per-chunk buffers sized to a THIRD of the budget: the
    stream double-buffers (chunk c+1 transfers while chunk c computes) and
    the epoch scan's while-loop state holds one more copy of the active
    buffer during each dispatch (the same XLA loop-constant copy
    ``pin_plan`` accounts for on the pinned tier), so peak feature HBM is
    3x the buffer size.  ``feature_dtype``: see :func:`from_examples`
    (narrower storage shrinks both the buffer HBM and the per-chunk
    transfer bytes)."""
    import jax
    import jax.numpy as jnp

    captions, lengths = pad_captions([e.caption_ids for e in examples],
                                     max_len)
    images, image_index = _pack_unique(examples, image_provider)
    if feature_dtype is not None:
        images = images.astype(feature_dtype)
    per = int(images[0].nbytes)
    capacity = max(int((budget_bytes // 3) // per), batch_size)
    # a chunk never needs more unique rows than the split has, or than one
    # full-dedup chunk of rows_per_chunk batches can reference
    capacity = min(capacity, images.shape[0])
    if mesh is not None:
        from icee_tpu.parallel.mesh import replicated

        sh = replicated(mesh)
        put = lambda a: jax.device_put(a, sh)  # noqa: E731
    else:
        put = jnp.asarray
    return StreamedCaptionData(
        images=None,
        captions=put(captions),
        lengths=put(lengths),
        num_examples=len(examples),
        batch_size=batch_size,
        shuffle=shuffle,
        seed=seed,
        references=[e.all_caption_ids for e in examples],
        image_index=image_index,
        host_features=images,
        capacity=capacity,
        mesh=mesh,
    )


def from_styled(
    caption_ids: List[List[int]],
    batch_size: int,
    max_len: int,
    shuffle: bool = True,
    seed: int = 0,
    mesh=None,
) -> DeviceCaptionData:
    """Pack a text-only styled corpus (the reference's ``get_style_loader``
    data, ``stylenet/data_loader.py:183-197``) for whole-epoch device
    training: captions/lengths pinned on device, ``images=None`` (the paper
    regime's emotion passes carry no features, ``stylenet/train.py:356-387``).
    """
    import jax
    import jax.numpy as jnp

    captions, lengths = pad_captions(caption_ids, max_len)
    if mesh is not None:
        from icee_tpu.parallel.mesh import replicated

        sh = replicated(mesh)
        put = lambda a: jax.device_put(a, sh)  # noqa: E731
    else:
        put = jnp.asarray
    return DeviceCaptionData(
        images=None,
        captions=put(captions),
        lengths=put(lengths),
        num_examples=len(caption_ids),
        batch_size=batch_size,
        shuffle=shuffle,
        seed=seed,
    )


# Share of the memory a GPU process reserved (``bytes_limit``) that pinned
# or streamed features may take by default, leaving room for parameters,
# optimizer state, activations and compiler staging.
GPU_BUDGET_FRACTION = 0.25
CPU_BUDGET_BYTES = 4 << 30


def default_budget_bytes(device=None) -> int:
    """Feature budget for the residency tiers: on a GPU,
    :data:`GPU_BUDGET_FRACTION` of ``device.memory_stats()["bytes_limit"]``;
    elsewhere :data:`CPU_BUDGET_BYTES`.  ``--device_budget_gb`` overrides."""
    import jax

    device = device or jax.devices()[0]
    stats = device.memory_stats() if device.platform == "gpu" else None
    if stats and stats.get("bytes_limit"):
        return int(GPU_BUDGET_FRACTION * stats["bytes_limit"])
    return CPU_BUDGET_BYTES


def fits_device(
    num_examples: int,
    feature_shape: Tuple[int, ...],
    budget_bytes: int = 4 << 30,
) -> bool:
    """Conservative device-memory gate for pinning a split (see
    :func:`default_budget_bytes` for the budget the CLI passes).
    ``num_examples`` should be the UNIQUE-image count — features are
    deduplicated by :func:`from_examples` (5-ref splits pin one copy)."""
    per = int(np.prod(feature_shape)) * 4
    return num_examples * per <= budget_bytes


def pin_plan(
    num_examples: int,
    feature_shape: Tuple[int, ...],
    budget_bytes: int = 4 << 30,
    bytes_per_feature: int = 4,
) -> str:
    """Device-residency tier for a split under ``budget_bytes`` of device
    feature budget:

    - ``"epoch"``: 2x the feature bytes fit — whole-epoch one-dispatch
      ``lax.scan`` programs (XLA threads the pinned array through the
      while-loop state, which copies it once per dispatch);
    - ``"per_batch"``: 1x fits but 2x does not — features stay pinned and
      each batch runs as one no-scan jitted dispatch (no loop, no copy);
    - ``"stream"``: features exceed the budget — chunk-streamed epochs
      (:class:`StreamedCaptionData`).

    ``num_examples`` is the UNIQUE-image count, as for :func:`fits_device`;
    ``bytes_per_feature`` follows the storage dtype (2 for bf16 features —
    ``from_examples(feature_dtype=...)`` halves every wall).
    """
    per = int(np.prod(feature_shape)) * bytes_per_feature
    total = num_examples * per
    if 2 * total <= budget_bytes:
        return "epoch"
    if total <= budget_bytes:
        return "per_batch"
    return "stream"
