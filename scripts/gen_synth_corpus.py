"""Scaled synthetic Indonesian caption corpus (VERDICT r3 #5).

Real Flickr8k-id data is absent from this environment, so the convergence
run needs a corpus that is (a) reference-scale (~30k captions, vocab in the
3-8k band), (b) LEARNABLE: captions are generated from per-image latent
scenes, and the cached "image features" are deterministic functions of the
same scene (plus noise), so a captioner genuinely has signal to learn —
loss/ppl/BLEU trajectories are meaningful, not noise.

Output layout (default /tmp/icee_conv):
  train.txt / val.txt / test.txt     name.jpg#i<TAB>caption. lines
  happy.txt / sad.txt / angry.txt    styled text-only corpora + val_*.txt
  features.npz                       name -> (2048,) f32 pooled feature

Vocabulary comes from Zipf draws over suffixed word pools (subjects, verbs,
objects, places, modifiers), giving ~4-6k distinct surface forms at 30k
captions — the reference's Flickr8k-id scale (SURVEY §6).
"""

import argparse
import os
import zlib

import numpy as np


def pool(prefix, n):
    return [f"{prefix}{i:03d}" for i in range(n)]


SUBJECTS = ["anak", "pria", "wanita", "anjing", "kucing", "petani",
            "penari", "pelari"] + pool("orang", 1500)
VERBS = ["bermain", "berlari", "duduk", "melompat", "membawa", "menatap",
         "memegang", "menendang"] + pool("kegiatan", 1500)
OBJECTS = ["bola", "layangan", "sepeda", "buku", "topi", "kamera",
           "payung", "galah"] + pool("benda", 2000)
PLACES = ["lapangan", "pantai", "taman", "jalan", "pasar", "sungai",
          "halaman", "hutan"] + pool("tempat", 1200)
MODS = ["merah", "biru", "kecil", "besar", "tua", "muda", "cepat",
        "lambat"] + pool("sifat", 1000)

TEMPLATES = [
    "seorang {s} sedang {v} {o} di {p}",
    "{s} {mod} itu {v} {o} di {p}",
    "di {p} seorang {s} {v} {o}",
    "{s} yang {mod} {v} sebuah {o}",
    "seorang {s} {v} {o} {mod} di {p}",
]
EMO_TAILS = {"happy": ["dengan gembira", "sambil tertawa senang",
                       "dengan riang"],
             "sad": ["dengan sedih", "sambil menangis", "dengan murung"],
             "angry": ["dengan marah", "sambil membentak", "dengan kesal"]}


def zipf_choice(rng, items, a=0.9):
    w = 1.0 / np.arange(1, len(items) + 1) ** a
    return items[int(rng.choice(len(items), p=w / w.sum()))]


def scene(rng):
    return {"s": zipf_choice(rng, SUBJECTS), "v": zipf_choice(rng, VERBS),
            "o": zipf_choice(rng, OBJECTS), "p": zipf_choice(rng, PLACES),
            "mod": zipf_choice(rng, MODS)}


def caption(rng, sc, emotion=None):
    tpl = TEMPLATES[int(rng.integers(len(TEMPLATES)))]
    c = tpl.format(**sc)
    if emotion:
        c += " " + EMO_TAILS[emotion][int(rng.integers(3))]
    return c + "."


def _stable_hash(key, value) -> int:
    """A seed for the direction of one attribute value, the same in every
    process (Python's ``hash`` of a string changes from run to run)."""
    return zlib.crc32(f"{key}={value}".encode())


def attr_feature(rng_feat, sc, dim=2048, noise=0.1):
    """Deterministic scene embedding + per-image noise: each attribute
    value hashes to a fixed random direction, the feature is their sum —
    so features genuinely predict the caption content."""
    v = np.zeros(dim, np.float32)
    for key in ("s", "v", "o", "p", "mod"):
        h = _stable_hash(key, sc[key])
        r = np.random.default_rng(h)
        v += r.standard_normal(dim).astype(np.float32)
    v /= np.linalg.norm(v) / 6.0
    return v + noise * rng_feat.standard_normal(dim).astype(np.float32)


def spatial_feature(rng_feat, sc, grid=196, dim=2048, noise=0.1,
                    occupancy=24):
    """Spatial (P=196, 2048) variant for the attention families: each
    attribute's direction occupies a per-image RANDOM subset of ~24 grid
    positions (the rest is noise), so attention has genuine localization
    signal to learn — the mean feature still carries the scene (coverage-
    scaled), matching how the attention decoders init h/c from the mean."""
    v = noise * rng_feat.standard_normal((grid, dim)).astype(np.float32)
    for key in ("s", "v", "o", "p", "mod"):
        h = _stable_hash(key, sc[key])
        r = np.random.default_rng(h)
        d = r.standard_normal(dim).astype(np.float32)
        d /= np.linalg.norm(d) / 6.0
        pos = rng_feat.choice(grid, size=occupancy, replace=False)
        v[pos] += d
    return v


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/icee_conv")
    ap.add_argument("--n_train", type=int, default=6000)
    ap.add_argument("--n_val", type=int, default=500)
    ap.add_argument("--n_test", type=int, default=500)
    ap.add_argument("--refs", type=int, default=5)
    ap.add_argument("--n_styled", type=int, default=1500)
    ap.add_argument("--spatial", action="store_true",
                    help="write (196, 2048) spatial features for the "
                         "attention families instead of pooled (2048,)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    rng_feat = np.random.default_rng(args.seed + 1)

    feats = {}
    vocab = set()
    n_total = args.n_train + args.n_val + args.n_test
    splits = (("train", 0, args.n_train),
              ("val", args.n_train, args.n_train + args.n_val),
              ("test", args.n_train + args.n_val, n_total))
    scenes = [scene(rng) for _ in range(n_total)]
    n_caps = 0
    for name, lo, hi in splits:
        with open(os.path.join(args.out, f"{name}.txt"), "w") as f:
            for i in range(lo, hi):
                img = f"img{i:05d}.jpg"
                feats[img] = (spatial_feature(rng_feat, scenes[i])
                              if args.spatial
                              else attr_feature(rng_feat, scenes[i]))
                for r in range(args.refs):
                    c = caption(rng, scenes[i])
                    vocab.update(c[:-1].split())
                    f.write(f"{img}#{r}\t{c}\n")
                    n_caps += 1

    # styled corpora: IMAGE-PAIRED (``img#0<TAB>caption``) for the
    # multitask/transfer/seq2seq trainers (FlickrStyle semantics — styled
    # caption of an existing image's scene, data/captions.py), train drawn
    # from train images and val from val images; plus text-only variants
    # (``paper_*.txt``) for the StyleNet-paper regime.
    for emo in ("happy", "sad", "angry"):
        for prefix, n, lo, hi in (
                ("", args.n_styled, 0, args.n_train),
                ("val_", args.n_styled // 5, args.n_train,
                 args.n_train + args.n_val)):
            with open(os.path.join(args.out, f"{prefix}{emo}.txt"),
                      "w") as f:
                for _ in range(n):
                    i = int(rng.integers(lo, hi))
                    c = caption(rng, scenes[i], emotion=emo)
                    vocab.update(c[:-1].split())
                    f.write(f"img{i:05d}.jpg#0\t{c}\n")
                    n_caps += 1
        with open(os.path.join(args.out, f"paper_{emo}.txt"), "w") as f:
            for _ in range(args.n_styled):
                c = caption(rng, scene(rng), emotion=emo)
                vocab.update(c[:-1].split())
                f.write(c + "\n")
                n_caps += 1

    # vocab source = factual train + styled corpora concatenated (styled
    # tail words must be in-vocab for the language passes to be learnable;
    # build_vocab keeps text after the last tab, so plain lines pass
    # through unchanged)
    with open(os.path.join(args.out, "vocab_src.txt"), "w") as out:
        for fn in ("train.txt", "happy.txt", "sad.txt", "angry.txt"):
            with open(os.path.join(args.out, fn)) as f:
                out.write(f.read())

    np.savez(os.path.join(args.out, "features.npz"), **feats)
    print(f"{n_caps} captions, {len(feats)} images, "
          f"surface vocab ~{len(vocab)} -> {args.out}")


if __name__ == "__main__":
    main()
