"""Cross-request serving batching: one batched beam decode per window.

The reference serves one request at a time (``app/backend/run.py:23-61``);
round 1 fixed its reload-per-request hot spot but still decoded each request
alone.  On an accelerator the beam decode is throughput-bound — a
(batch, k, ...) beam costs barely more than a single image — so concurrent
requests SHOULD share one device call.

:class:`BatchingEngine` wraps :class:`icee_tpu.serve.engine.CaptionEngine`
with the same ``caption(image_path, mode)`` contract.  Concurrent callers
enqueue; a collector thread drains the queue for a small window
(``window_ms``, default 4 ms) or until ``max_batch``, groups requests by
mode, and decodes each (variant, mode) group with ONE batched device call
(``decode/fast.py``).  Feature batches are padded to the next power of two
so each (variant, batch-bucket) compiles once.

``beam_search_batched`` is proved equivalent to ``vmap(beam_search)``
(``tests/test_beam_batched.py``), so captions are identical to the serial
path — asserted by the threaded test in ``tests/test_serve_batching.py``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List

from icee_tpu.core.config import MODES, mode_id
from icee_tpu.serve.config import MODEL_VARIANTS


class _Pending:
    __slots__ = ("image_path", "mode", "event", "result", "error")

    def __init__(self, image_path: str, mode: str):
        self.image_path = image_path
        self.mode = mode
        self.event = threading.Event()
        self.result = None
        self.error = None


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class BatchingEngine:
    """Same ``caption()`` contract as CaptionEngine, batched across threads."""

    def __init__(self, engine, window_ms: float = 4.0, max_batch: int = 8,
                 k: int = 5):
        self.engine = engine
        self.window = window_ms / 1e3
        self.max_batch = max_batch
        self.k = k
        self.group_sizes: List[int] = []  # instrumentation (tests/metrics)
        self._q: "queue.SimpleQueue[_Pending]" = queue.SimpleQueue()
        self._decode_cache: Dict = {}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="caption-batcher")
        self._thread.start()

    # -- public -------------------------------------------------------------

    def caption(self, image_path: str, mode: str) -> Dict[str, str]:
        if mode not in MODES:
            raise ValueError(f"invalid mode {mode}")
        item = _Pending(image_path, mode)
        self._q.put(item)
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    # -- collector ----------------------------------------------------------

    def _loop(self):
        while True:
            batch = [self._q.get()]
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            by_mode: Dict[str, List[_Pending]] = {}
            for item in batch:
                by_mode.setdefault(item.mode, []).append(item)
            for mode, items in by_mode.items():
                try:
                    self._run_group(mode, items)
                except Exception as e:  # noqa: BLE001 - report to callers
                    for item in items:
                        item.error = e
                        item.event.set()

    def _run_group(self, mode: str, items: List[_Pending]):
        import jax.numpy as jnp

        from icee_tpu.models import encoder as enc_mod

        self.group_sizes.append(len(items))
        eng = self.engine
        style = jnp.asarray(mode_id(mode))
        pooled_list, spatial_list = [], []
        for item in items:
            pooled, spatial = eng._features(eng.decode_image(item.image_path))
            pooled_list.append(pooled)
            spatial_list.append(spatial[0])
        pooled_b = jnp.concatenate(pooled_list, axis=0)     # (n, 2048)
        spatial_b = jnp.stack(spatial_list, axis=0)         # (n, P, D)

        n = len(items)
        n_pad = _next_pow2(n)
        pad = [(0, n_pad - n)] if n_pad != n else None
        results = [{} for _ in items]
        for variant in MODEL_VARIANTS:
            pipeline = eng.models.get(variant, {}).get(mode)
            if pipeline is None:
                for r in results:
                    r[variant] = "-"
                continue
            if variant.endswith("_att"):
                feats = spatial_b
            else:
                feats, _ = enc_mod.encode_global_from_pooled(
                    pipeline["head"], pooled_b, train=False)
            if pad:
                feats = jnp.concatenate(
                    [feats] + [feats[:1]] * (n_pad - n), axis=0)
            res = self._batched_decode_fn(variant, mode, n_pad)(feats, style)
            for i, r in enumerate(results):
                r[variant] = eng._detok(res.tokens[i], res.length[i])
        for item, r in zip(items, results):
            item.result = r
            item.event.set()

    # -- batched decode builders --------------------------------------------

    def _batched_decode_fn(self, variant: str, mode: str, n: int):
        """Jitted ``beam_search_batched`` over ``n`` requests; cached per
        (variant, decoder, n) — mirrors ``CaptionEngine._decode_fn`` but
        natively batched."""
        eng = self.engine
        dec = eng.models[variant][mode]["decoder"]
        # the style id is an argument of the compiled decode, so every mode
        # of a shared decoder reuses one program
        key = (variant, id(dec), n)
        if key in self._decode_cache:
            return self._decode_cache[key]
        from icee_tpu.decode import fast

        cfg = eng.att_cfg if variant.endswith("_att") else eng.dec_cfg
        fn = fast.beam_fn(
            variant, dec, n, self.k, cfg.max_seq_length, len(eng.vocab),
            eng.vocab.start, eng.vocab.end, feed_feature=True)
        self._decode_cache[key] = fn
        return fn
