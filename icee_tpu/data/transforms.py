"""Image transforms as jitted XLA ops.

The reference composes torchvision transforms on the host per image
(``train_multitask.py:63-69``: Resize(336) -> RandomCrop(224) ->
RandomHorizontalFlip -> ToTensor -> ImageNet Normalize; eval/serving path is
Resize(224) -> ToTensor -> Normalize, ``sample.py:26-30``).

Split: the host decodes + resizes to a fixed size (PIL, matching
torchvision's bilinear resize), and the *random* crop/flip plus normalize run
as one jitted batched op on device — per-image PRNG, NHWC layout, fused with
the encoder forward by XLA.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def host_decode_resize(path_or_img, size: int) -> np.ndarray:
    """PIL decode + bilinear resize to (size, size, 3) uint8 — host side.

    Matches torchvision ``Resize((size, size))`` (PIL bilinear) on RGB input.
    """
    from PIL import Image

    img = path_or_img
    if not hasattr(img, "resize"):
        img = Image.open(img)
    img = img.convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def pick_image_decoder(size: int) -> Callable[[str], np.ndarray]:
    """The host JPEG decoder for uploads, chosen once: PIL if installed,
    else the libjpeg decoder built from ``native/imagedec.cpp``.  Either
    returns a ``(size, size, 3)`` uint8 array, the device path's input.
    Raises ``RuntimeError`` naming both when neither is available."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        from icee_tpu.native import imagedec

        if not imagedec.native_available():
            raise RuntimeError(
                "no JPEG decoder: install Pillow, or provide g++ and libjpeg "
                "so icee_tpu/native/imagedec.cpp can be built") from None
        return lambda path: imagedec.decode_resize_paths([path], size)[0]
    return lambda path: host_decode_resize(path, size)


def normalize(images: jax.Array) -> jax.Array:
    """uint8/float [0,255] NHWC -> ImageNet-normalized float32."""
    x = images.astype(jnp.float32) / 255.0
    mean = jnp.asarray(IMAGENET_MEAN, jnp.float32)
    std = jnp.asarray(IMAGENET_STD, jnp.float32)
    return (x - mean) / std


@partial(jax.jit, static_argnames=("crop_size",))
def train_augment(
    images: jax.Array, key: jax.Array, crop_size: int = 224
) -> jax.Array:
    """Batched RandomCrop + RandomHorizontalFlip + Normalize under jit.

    ``images``: (B, H, W, 3) uint8 (already resized on host).  Uses a
    per-image random crop offset and flip coin like torchvision applies
    per-sample transforms.
    """
    b, h, w, _ = images.shape
    k_y, k_x, k_flip = jax.random.split(key, 3)
    max_y = h - crop_size
    max_x = w - crop_size
    # torchvision RandomCrop draws offsets from [0, dim-crop] INCLUSIVE
    off_y = jax.random.randint(k_y, (b,), 0, max_y + 1)
    off_x = jax.random.randint(k_x, (b,), 0, max_x + 1)
    offs = jnp.stack([off_y, off_x], axis=1)
    flips = jax.random.bernoulli(k_flip, 0.5, (b,))

    def crop_one(img, off, flip):
        out = jax.lax.dynamic_slice(
            img, (off[0], off[1], 0), (crop_size, crop_size, 3)
        )
        return jax.lax.cond(flip, lambda x: x[:, ::-1, :], lambda x: x, out)

    cropped = jax.vmap(crop_one)(images, offs, flips)
    return normalize(cropped)


@partial(jax.jit, static_argnames=("crop_size",))
def eval_preprocess(images: jax.Array, crop_size: int = 224) -> jax.Array:
    """Deterministic center-size path: images already resized to crop size on
    host (reference eval uses Resize(224) directly, ``sample.py:26-30``)."""
    del crop_size
    return normalize(images)
