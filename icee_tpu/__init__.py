"""icee_tpu — Indonesian emotional image-captioning framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
``deryrahman/image-caption-emotion-indonesia`` (mounted read-only at
``/root/reference``): four captioning model families (NIC, StyleNet
FactoredLSTM, attention variants, seq2seq style transfer, SentiCap switched
LSTM), their training regimes, beam-search inference, BLEU evaluation,
checkpointing, and a serving app — built for XLA:

- fixed-shape masked batches instead of packed sequences,
- ``lax.scan`` programs instead of per-timestep Python loops,
- shape-stable masked beam search under ``jit`` instead of dynamic beam
  shrinking,
- ``jax.sharding.Mesh`` + pjit data/tensor parallelism instead of a single
  device.

Package map (see SURVEY.md §2 for the reference inventory each module covers):

- :mod:`icee_tpu.core`       — configs, initializers, the per-platform policy
- :mod:`icee_tpu.data`       — tokenizer, vocabulary, caption files, batching
- :mod:`icee_tpu.models`     — encoders + decoder families
- :mod:`icee_tpu.ops`        — recurrent cells and the chunked training loss
- :mod:`icee_tpu.decode`     — greedy & beam search
- :mod:`icee_tpu.train`      — training regimes (multitask, transfer, seq2seq)
- :mod:`icee_tpu.evaluation` — BLEU / perplexity / top-k metrics
- :mod:`icee_tpu.checkpoint` — NumPy checkpoints + torch import shims
- :mod:`icee_tpu.parallel`   — mesh construction and sharding rules
- :mod:`icee_tpu.serve`      — HTTP caption service (reference app parity)
- :mod:`icee_tpu.cli`        — reference-compatible command-line entry points
- :mod:`icee_tpu.senticap`   — SentiCap switched-LSTM model family
"""

__version__ = "0.1.0"
