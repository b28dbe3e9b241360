"""``python -m icee_tpu.cli.precompute_features`` — encode every unique
image ONCE into an npz feature cache.

The fast path (SURVEY.md §7: the reference recomputes the frozen
ResNet-152 on every image every epoch — caching is a free win): this tool
produces the ``--feature_cache`` file the train/evaluate/validate CLIs
consume.  Batches images through the jitted backbone on the accelerator.

Writes pooled (B, 2048) features by default, spatial ``(P, 2048)`` grids
with ``--spatial`` (attention models).
"""

import argparse
import os

import numpy as np


def main(args) -> None:
    from icee_tpu.core.backend import start_entry_point

    start_entry_point()
    import jax
    import jax.numpy as jnp

    from icee_tpu.cli.common import load_resnet_params
    from icee_tpu.data.captions import parse_caption_file
    from icee_tpu.data.transforms import host_decode_resize, normalize
    from icee_tpu.models import resnet

    names = sorted({n for n, _ in parse_caption_file(args.caption_path)})
    print(f"{len(names)} unique images")

    backbone = load_resnet_params(
        args.resnet_weights, getattr(args, "backbone_dtype", "float32"))
    if args.resnet_weights is None:
        print("WARNING: no --resnet_weights; random backbone (smoke mode)")

    grid = args.grid

    @jax.jit
    def encode(imgs):
        x = normalize(imgs)
        fmap, _ = resnet.forward(backbone, x, train_bn=False)
        if args.spatial:
            sp = resnet.adaptive_avg_pool(fmap, (grid, grid))
            return sp.reshape(sp.shape[0], grid * grid, sp.shape[-1])
        return jnp.mean(fmap, axis=(1, 2))

    # opt-in: the native resize is classic bilinear, not PIL's antialiased
    # filter, so the default stays on the torchvision-parity PIL path
    from icee_tpu.native import imagedec

    use_native = args.native_decode and imagedec.native_available()
    if use_native:
        print("native libjpeg batch feeder active (C++ threads)")

    def load_chunk(chunk):
        jpeg_like = [n for n in chunk
                     if n.lower().endswith((".jpg", ".jpeg"))]
        if use_native and len(jpeg_like) == len(chunk):
            # C++ threaded decode+resize, one call per batch (no GIL)
            return imagedec.decode_resize_paths(
                [os.path.join(args.image_dir, n) for n in chunk],
                args.crop_size)
        return np.stack([
            host_decode_resize(os.path.join(args.image_dir, n),
                               args.crop_size)
            for n in chunk
        ])

    out = {}
    bs = args.batch_size
    for i in range(0, len(names), bs):
        chunk = names[i : i + bs]
        imgs = load_chunk(chunk)
        n = imgs.shape[0]
        if n < bs:  # pad to the compiled shape
            imgs = np.concatenate(
                [imgs, np.zeros((bs - n,) + imgs.shape[1:], imgs.dtype)])
        feats = np.asarray(encode(jnp.asarray(imgs)))[:n]
        for name, f in zip(chunk, feats):
            out[name] = f
        print(f"  {min(i + bs, len(names))}/{len(names)}")
    np.savez(args.out, **out)
    print(f"wrote {len(out)} features to {args.out}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--caption_path", type=str, required=True,
                        help="caption file listing the images to encode")
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--out", type=str, default="features.npz")
    parser.add_argument("--resnet_weights", type=str, default=None)
    parser.add_argument("--crop_size", type=int, default=224)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--spatial", action="store_true")
    parser.add_argument("--grid", type=int, default=14)
    parser.add_argument("--backbone_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="ResNet conv precision (bfloat16 convs on "
                             "the tensor cores)")
    parser.add_argument("--native_decode", action="store_true",
                        help="C++ libjpeg threaded batch feeder (faster; "
                             "classic bilinear resize instead of PIL's "
                             "antialiased filter)")
    main(parser.parse_args())
