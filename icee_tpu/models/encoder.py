"""CNN encoders: frozen ResNet-152 backbone + trainable projection head.

Parity targets (SURVEY.md M1/M2):

- global ``EncoderCNN`` (``stylenet/model.py:11-27``): frozen ResNet-152 minus
  fc -> Linear(2048 -> embed) -> BatchNorm1d(momentum=0.01); only the head
  trains,
- spatial ``EncoderCNN`` (``stylenet/model_att.py:11-29``): ResNet-152 minus
  fc+pool, adaptive-avg-pool to a 14x14 grid, no trainable parameters beyond
  the (frozen) backbone.

Design: the backbone runs under ``jax.lax.stop_gradient`` (the analogue of
``torch.no_grad`` in a functional setting) so XLA never materializes backbone
gradients; features can also be precomputed once and cached device-side across
epochs (the reference recomputes the frozen backbone every epoch — SURVEY.md
§7 flags feature caching as a free win).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from icee_tpu.core.config import EncoderConfig
from icee_tpu.core import initializers as init
from icee_tpu.models import resnet


def init_head_params(key: jax.Array, cfg: EncoderConfig, dtype=jnp.float32) -> dict:
    """Trainable head: Linear(2048 -> embed) with torch default init + BN."""
    k_w, k_b = jax.random.split(key)
    return {
        "linear_w": init.torch_linear_default(
            k_w, (cfg.feature_size, cfg.embed_size), cfg.feature_size, dtype
        ),
        "linear_b": init.torch_linear_default(
            k_b, (cfg.embed_size,), cfg.feature_size, dtype
        ),
        "bn": {
            "weight": jnp.ones((cfg.embed_size,), dtype),
            "bias": jnp.zeros((cfg.embed_size,), dtype),
            "running_mean": jnp.zeros((cfg.embed_size,), dtype),
            "running_var": jnp.ones((cfg.embed_size,), dtype),
        },
    }


def apply_head(
    head: dict, pooled: jax.Array, train: bool, bn_momentum: float = 0.01
) -> Tuple[jax.Array, dict]:
    """Linear + BatchNorm1d(momentum=0.01) (``model.py:26``). Returns
    (features (B, embed), head-with-updated-running-stats)."""
    x = pooled @ head["linear_w"] + head["linear_b"]
    out, new_bn = resnet.batch_norm(x, head["bn"], train, momentum=bn_momentum)
    new_head = dict(head)
    new_head["bn"] = new_bn
    return out, new_head


def encode_global(
    backbone: dict,
    head: dict,
    images: jax.Array,
    train: bool = True,
    backbone_train_bn: bool = False,
    bn_momentum: float = 0.01,
) -> Tuple[jax.Array, dict, dict]:
    """Global encoder forward -> ((B, embed), new_backbone, new_head).

    The backbone output is wrapped in ``stop_gradient`` (frozen, like
    ``torch.no_grad`` at ``model.py:23-24``).  ``backbone_train_bn=True``
    reproduces the reference quirk where frozen-backbone BatchNorms still use
    batch stats and update running stats during training.
    """
    pooled, new_backbone = resnet.global_features(
        backbone, images, train_bn=backbone_train_bn
    )
    pooled = jax.lax.stop_gradient(pooled)
    feats, new_head = apply_head(head, pooled, train, bn_momentum)
    return feats, new_backbone, new_head


def encode_spatial(
    backbone: dict,
    images: jax.Array,
    grid: int = 14,
    backbone_train_bn: bool = False,
) -> Tuple[jax.Array, dict]:
    """Spatial encoder forward -> ((B, grid*grid, 2048), new_backbone),
    flattened for attention (``model_att.py:22-29`` + ``:249``)."""
    fmap, new_backbone = resnet.spatial_features(
        backbone, images, grid=grid, train_bn=backbone_train_bn
    )
    fmap = jax.lax.stop_gradient(fmap)
    b = fmap.shape[0]
    return fmap.reshape(b, grid * grid, fmap.shape[-1]), new_backbone


def encode_global_from_pooled(
    head: dict, pooled: jax.Array, train: bool = True, bn_momentum: float = 0.01
) -> Tuple[jax.Array, dict]:
    """Head-only path for cached backbone features (the fast path:
    run the frozen backbone once per image, reuse across epochs)."""
    return apply_head(head, pooled, train, bn_momentum)
