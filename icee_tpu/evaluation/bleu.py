"""Corpus BLEU with bit-parity to ``nltk.translate.bleu_score``.

The reference's quality metric is NLTK ``corpus_bleu`` with no smoothing —
default 4-gram weights in validation (``train_multitask.py:341``) and
cumulative 1..4-gram weights at test (``evaluator.py:105-120``).  The BLEU
parity claim in BASELINE.md requires bit-identical behavior, so this is a
standalone implementation of the same micro-averaged algorithm:

- per-hypothesis modified n-gram precision with reference-count clipping,
  numerators/denominators summed over the corpus,
- closest-reference-length brevity penalty (ties -> shorter reference),
- method0 "smoothing": zero precisions become ``sys.float_info.min``
  (NOT exact zero — this quirk matters for cumulative scores),
- zero unigram matches -> exact 0.

Golden-tested against the installed NLTK in ``tests/test_bleu.py``.
This is host-side Python over token lists (tiny corpora); the heavy part of
evaluation — batched beam decode — runs on the accelerator.
"""

from __future__ import annotations

import math
import sys
from collections import Counter
from typing import Iterable, List, NamedTuple, Sequence, Tuple


class Precision(NamedTuple):
    """Unreduced modified-precision fraction (NLTK keeps an unnormalized
    Fraction here; exact integer counts are what the micro-average sums)."""

    numerator: int
    denominator: int

    def __float__(self) -> float:
        return self.numerator / self.denominator


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def modified_precision(
    references: Sequence[Sequence], hypothesis: Sequence, n: int
) -> Precision:
    """Clipped n-gram precision for one hypothesis (Papineni et al. 2002)."""
    hyp_counts = _ngrams(hypothesis, n)
    max_ref = Counter()
    for ref in references:
        for gram, cnt in _ngrams(ref, n).items():
            if cnt > max_ref[gram]:
                max_ref[gram] = cnt
    clipped = {g: min(c, max_ref[g]) for g, c in hyp_counts.items()}
    numerator = sum(clipped.values())
    denominator = max(1, sum(hyp_counts.values()))
    return Precision(numerator, denominator)


def closest_ref_length(references: Sequence[Sequence], hyp_len: int) -> int:
    """Reference length closest to the hypothesis (ties -> shortest)."""
    return min((len(r) for r in references),
               key=lambda rl: (abs(rl - hyp_len), rl))


def brevity_penalty(closest_ref_len: int, hyp_len: int) -> float:
    if hyp_len > closest_ref_len:
        return 1.0
    if hyp_len == 0:
        return 0.0
    return math.exp(1 - closest_ref_len / hyp_len)


def corpus_bleu(
    list_of_references: Sequence[Sequence[Sequence]],
    hypotheses: Sequence[Sequence],
    weights=(0.25, 0.25, 0.25, 0.25),
) -> float:
    """Micro-averaged corpus BLEU, NLTK-method0 semantics."""
    if len(list_of_references) != len(hypotheses):
        raise ValueError(
            "The number of hypotheses and their reference(s) should be the same"
        )
    try:
        weights[0][0]
        weight_list = list(weights)
    except (TypeError, IndexError):
        weight_list = [weights]
    max_n = max(len(w) for w in weight_list)

    p_num = Counter()
    p_den = Counter()
    hyp_lengths = 0
    ref_lengths = 0
    for references, hypothesis in zip(list_of_references, hypotheses):
        for i in range(1, max_n + 1):
            p_i = modified_precision(references, hypothesis, i)
            p_num[i] += p_i.numerator
            p_den[i] += p_i.denominator
        hyp_len = len(hypothesis)
        hyp_lengths += hyp_len
        ref_lengths += closest_ref_length(references, hyp_len)

    bp = brevity_penalty(ref_lengths, hyp_lengths)

    if p_num[1] == 0:
        return 0 if len(weight_list) == 1 else [0] * len(weight_list)

    # method0: zero precisions -> smallest positive float
    p_n: List[float] = []
    for i in range(1, max_n + 1):
        if p_num[i] != 0:
            p_n.append(p_num[i] / p_den[i])
        else:
            p_n.append(sys.float_info.min)

    scores = []
    for weight in weight_list:
        s = (w_i * math.log(p_i) for w_i, p_i in zip(weight, p_n) if p_i > 0)
        scores.append(bp * math.exp(math.fsum(s)))
    return scores[0] if len(weight_list) == 1 else scores


def sentence_bleu(
    references: Sequence[Sequence], hypothesis: Sequence,
    weights=(0.25, 0.25, 0.25, 0.25),
) -> float:
    return corpus_bleu([references], [hypothesis], weights)


# convenience: the evaluator CLI's cumulative weight ladder
# (stylenet/evaluator.py:105-116)
CUMULATIVE_WEIGHTS: Tuple[tuple, ...] = (
    (1.0,),
    (0.5, 0.5),
    (1 / 3, 1 / 3, 1 / 3),
    (0.25, 0.25, 0.25, 0.25),
)


def bleu_1_to_4(list_of_references, hypotheses) -> List[float]:
    """BLEU-1..4 with the evaluator CLI's cumulative weights."""
    return [
        corpus_bleu(list_of_references, hypotheses, w) for w in CUMULATIVE_WEIGHTS
    ]
