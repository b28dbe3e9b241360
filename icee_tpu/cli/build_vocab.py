"""``python -m icee_tpu.cli.build_vocab`` — reference-compatible vocab CLI
(``stylenet/build_vocab.py:64-88``): same flags, same pickle output."""

import argparse
import pickle

from icee_tpu.data.vocab import build_vocab


def main(args) -> None:
    from icee_tpu.core.backend import start_entry_point

    start_entry_point()
    vocab = build_vocab(path=args.caption_path, threshold=args.threshold)
    with open(args.vocab_path, "wb") as f:
        pickle.dump(vocab, f)
    print("Total vocabulary size: {}".format(len(vocab)))
    print("Saved the vocabulary wrapper to '{}'".format(args.vocab_path))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--caption_path", type=str,
                        default="data/flickr8k/train.txt",
                        help="path for train annotation file")
    parser.add_argument("--vocab_path", type=str,
                        default="./data/flickr8k/vocab.pkl",
                        help="path for saving vocabulary wrapper")
    parser.add_argument("--threshold", type=int, default=4,
                        help="minimum word count threshold")
    main(parser.parse_args())
