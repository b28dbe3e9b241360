"""ResNet-152 backbone as a jitted XLA graph (NHWC, bf16-capable).

The reference uses torchvision's pretrained ``resnet152`` with the fc layer
removed, frozen under ``no_grad`` (``stylenet/model.py:15-24``; spatial
variant keeps the conv map and adaptive-pools to 14x14,
``stylenet/model_att.py:13-29``).  Pretrained weights are not downloadable in
this environment, so this module provides:

- a faithful torchvision-architecture forward (bottleneck v1, layers
  [3, 8, 36, 3]) in NHWC layout — the conv/matmul-heavy path XLA hands to
  cuDNN and the tensor cores,
- :func:`import_torch_state_dict` converting any torchvision ``resnet152``
  ``state_dict`` (pretrained or not) into our parameter pytree — numerical
  parity is tested against torch's own forward on random weights,
- both BatchNorm behaviors: eval mode (running stats — the fast default) and
  the reference's train-mode quirk where the *frozen* backbone still
  normalizes by batch stats and updates running stats (torch BN under
  ``no_grad`` in ``model.train()``).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

LAYERS_152 = (3, 8, 36, 3)
PLANES = (64, 128, 256, 512)
EXPANSION = 4


# --- primitive layers ----------------------------------------------------

def conv(x: jax.Array, w: jax.Array, stride: int = 1, padding=None) -> jax.Array:
    """NHWC conv with HWIO weights.

    Default padding is torch's symmetric ``(k-1)//2`` — NOT XLA "SAME", which
    pads asymmetrically for even inputs under stride 2 and shifts the conv
    windows relative to torch.
    """
    if padding is None:
        ph = (w.shape[0] - 1) // 2
        pw = (w.shape[1] - 1) // 2
        padding = ((ph, ph), (pw, pw))
    # run the conv in the WEIGHT dtype with f32 accumulation: bf16 weights
    # run the whole backbone in bf16 on the tensor cores (a no-op cast
    # for the default f32 params — mixed dtypes would otherwise silently
    # promote to f32 and lose the speedup).  BN params stay f32 either way.
    return jax.lax.conv_general_dilated(
        x.astype(w.dtype), w, (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )


def batch_norm(
    x: jax.Array, p: Dict[str, jax.Array], train: bool, momentum: float = 0.1
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """torch-semantics BN: train mode normalizes by biased batch stats and
    updates running stats with *unbiased* variance; eval uses running stats."""
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axis=axes)
        var = jnp.var(x, axis=axes)
        n = x.size // x.shape[-1]
        unbiased = var * n / max(n - 1, 1)
        new_p = dict(p)
        new_p["running_mean"] = (1 - momentum) * p["running_mean"] + momentum * mean
        new_p["running_var"] = (1 - momentum) * p["running_var"] + momentum * unbiased
    else:
        mean, var = p["running_mean"], p["running_var"]
        new_p = p
    inv = jax.lax.rsqrt(var + 1e-5)
    out = (x - mean) * inv * p["weight"] + p["bias"]
    return out, new_p


def max_pool_3x3_s2(x: jax.Array) -> jax.Array:
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1)."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        ((0, 0), (1, 1), (1, 1), (0, 0)),
    )


def adaptive_avg_pool(x: jax.Array, out_hw: Tuple[int, int]) -> jax.Array:
    """torch ``AdaptiveAvgPool2d`` semantics for NHWC input: output bin (i, j)
    averages rows [floor(i*H/oh), ceil((i+1)*H/oh))."""
    b, h, w, c = x.shape
    oh, ow = out_hw

    def pool_axis(arr, in_dim, out_dim, axis):
        pieces = []
        for i in range(out_dim):
            s = (i * in_dim) // out_dim
            e = -(-((i + 1) * in_dim) // out_dim)
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(s, e)
            pieces.append(jnp.mean(arr[tuple(sl)], axis=axis, keepdims=True))
        return jnp.concatenate(pieces, axis=axis)

    return pool_axis(pool_axis(x, h, oh, 1), w, ow, 2)


# --- bottleneck block ----------------------------------------------------

def bottleneck(x, p, stride: int, train_bn: bool):
    """torchvision Bottleneck v1 (1x1 -> 3x3 stride -> 1x1 x4) + identity."""
    new_p = dict(p)
    out = conv(x, p["conv1"], 1)
    out, new_p["bn1"] = batch_norm(out, p["bn1"], train_bn)
    out = jax.nn.relu(out)
    out = conv(out, p["conv2"], stride)
    out, new_p["bn2"] = batch_norm(out, p["bn2"], train_bn)
    out = jax.nn.relu(out)
    out = conv(out, p["conv3"], 1)
    out, new_p["bn3"] = batch_norm(out, p["bn3"], train_bn)
    if "downsample_conv" in p:
        identity = conv(x, p["downsample_conv"], stride)
        identity, new_p["downsample_bn"] = batch_norm(
            identity, p["downsample_bn"], train_bn
        )
    else:
        identity = x
    return jax.nn.relu(out + identity), new_p


def forward(
    params: dict, images: jax.Array, train_bn: bool = False
) -> Tuple[jax.Array, dict]:
    """images (B, H, W, 3) normalized -> (feature map (B, H/32, W/32, 2048),
    possibly-updated params)."""
    new_params = dict(params)
    x = conv(images, params["conv1"], 2, padding=((3, 3), (3, 3)))
    x, new_params["bn1"] = batch_norm(x, params["bn1"], train_bn)
    x = jax.nn.relu(x)
    x = max_pool_3x3_s2(x)
    for li, nblocks in enumerate(LAYERS_152):
        layer = list(params[f"layer{li + 1}"])
        for bi in range(nblocks):
            stride = 2 if (bi == 0 and li > 0) else 1
            x, layer[bi] = bottleneck(x, layer[bi], stride, train_bn)
        new_params[f"layer{li + 1}"] = layer
    return x, new_params


def global_features(params: dict, images: jax.Array, train_bn: bool = False):
    """Pooled (B, 2048) features — global EncoderCNN path (model.py:22-26)."""
    fmap, new_params = forward(params, images, train_bn)
    return jnp.mean(fmap, axis=(1, 2)), new_params


def spatial_features(
    params: dict, images: jax.Array, grid: int = 14, train_bn: bool = False
):
    """(B, grid, grid, 2048) features — spatial EncoderCNN path
    (model_att.py:22-29)."""
    fmap, new_params = forward(params, images, train_bn)
    return adaptive_avg_pool(fmap, (grid, grid)), new_params


def cast_conv_weights(params, dtype):
    """Cast only the CONV kernels to ``dtype`` (bf16 backbone mode); BN
    affine/running stats stay f32 — the cheap normalizations keep full
    precision while every conv runs in bf16."""
    def walk(node):
        if isinstance(node, dict):
            return {
                k: (v.astype(dtype) if k.startswith(("conv", "downsample_conv"))
                    else walk(v))
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


# --- init and torch import ----------------------------------------------

def _bn_init(c: int, dtype) -> dict:
    return {
        "weight": jnp.ones((c,), dtype),
        "bias": jnp.zeros((c,), dtype),
        "running_mean": jnp.zeros((c,), dtype),
        "running_var": jnp.ones((c,), dtype),
    }


def init_params(key: jax.Array, dtype=jnp.float32) -> dict:
    """He-normal random init (torchvision's default conv init), with the
    last BN scale of every residual branch at zero (torchvision's
    ``zero_init_residual``), so each block starts as the identity.

    Evaluated with untrained BN statistics, a plain init lets activations
    grow through all 50 blocks to values of order 1e4; this way the
    features of a random backbone stay of order one."""

    def he(k, shape):
        fan_out = shape[0] * shape[1] * shape[3]
        return jax.random.normal(k, shape, dtype) * np.sqrt(2.0 / fan_out)

    keys = iter(jax.random.split(key, 2048))
    params = {"conv1": he(next(keys), (7, 7, 3, 64)), "bn1": _bn_init(64, dtype)}
    in_c = 64
    for li, nblocks in enumerate(LAYERS_152):
        planes = PLANES[li]
        out_c = planes * EXPANSION
        blocks = []
        for bi in range(nblocks):
            p = {
                "conv1": he(next(keys), (1, 1, in_c, planes)),
                "bn1": _bn_init(planes, dtype),
                "conv2": he(next(keys), (3, 3, planes, planes)),
                "bn2": _bn_init(planes, dtype),
                "conv3": he(next(keys), (1, 1, planes, out_c)),
                "bn3": _bn_init(out_c, dtype),
            }
            p["bn3"]["weight"] = jnp.zeros((out_c,), dtype)
            if bi == 0:
                p["downsample_conv"] = he(next(keys), (1, 1, in_c, out_c))
                p["downsample_bn"] = _bn_init(out_c, dtype)
            blocks.append(p)
            in_c = out_c
        params[f"layer{li + 1}"] = blocks
    return params


def import_torch_state_dict(state_dict, dtype=jnp.float32) -> dict:
    """torchvision ``resnet152().state_dict()`` -> our pytree.

    Conv weights transpose OIHW -> HWIO; BN tensors copy through.  Accepts
    tensors or numpy arrays.
    """

    def arr(name):
        t = state_dict[name]
        a = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)
        return jnp.asarray(a, dtype)

    def conv_w(name):
        return jnp.transpose(arr(name), (2, 3, 1, 0))

    def bn(prefix):
        return {
            "weight": arr(f"{prefix}.weight"),
            "bias": arr(f"{prefix}.bias"),
            "running_mean": arr(f"{prefix}.running_mean"),
            "running_var": arr(f"{prefix}.running_var"),
        }

    params = {"conv1": conv_w("conv1.weight"), "bn1": bn("bn1")}
    for li, nblocks in enumerate(LAYERS_152):
        blocks = []
        for bi in range(nblocks):
            pre = f"layer{li + 1}.{bi}"
            p = {
                "conv1": conv_w(f"{pre}.conv1.weight"),
                "bn1": bn(f"{pre}.bn1"),
                "conv2": conv_w(f"{pre}.conv2.weight"),
                "bn2": bn(f"{pre}.bn2"),
                "conv3": conv_w(f"{pre}.conv3.weight"),
                "bn3": bn(f"{pre}.bn3"),
            }
            if f"{pre}.downsample.0.weight" in state_dict:
                p["downsample_conv"] = conv_w(f"{pre}.downsample.0.weight")
                p["downsample_bn"] = bn(f"{pre}.downsample.1")
            blocks.append(p)
        params[f"layer{li + 1}"] = blocks
    return params
