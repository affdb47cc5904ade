"""The one generator of the benchmark's traffic: English sentences.

A mix file (``traffic/<mix>.json``) names its client and a text file
(``"text"``: ``traffic/<text>.json``), whose parameters it shares with
every other mix of that text, and may add parameters of its client's
own; this module reads them and nothing else, so a new mix or text is a
new data file.

The sentences are one fixed text drawn from ``text_seed``: ``blocks``
blocks of ``block`` sentences.  Every block holds the same lengths: a
sentence's length in seconds is a quantile, at the midpoints of ``block``
equal steps, of the maximum-entropy distribution on the corpus's
[``min_seconds``, ``max_seconds``] with its mean (``seconds`` / ``clips``),
and its length in words that times the corpus's words a second.  Words are
drawn uniformly from ``word_list`` (the most frequent English words, with
numbers, money, ordinals and abbreviations, so that the text normaliser does
real work); commas fall after a word with probability ``comma_share`` and a
sentence ends with one of ``ends``.  A sentence whose phones (counted by
``count_phones``, the reference's frontend) exceed ``max_phones`` loses
words from its end until it fits.  A run's seed orders the sentences of
each block: every seed asks for the same work in another order, and a
read-aloud page (a block) holds the same sentences whatever the seed.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path

HERE = Path(__file__).resolve().parent
FRAME_RATE = 24000 / 384    # mel frames a second: 384 samples a frame at 24 kHz


def load_mix(name: str) -> dict:
    """The parameters of mix ``name`` (``traffic/<name>.json``) over those
    of the text it names; the two files' ``assumed`` are merged."""
    mix = json.loads((HERE / f"{name}.json").read_text())
    text = json.loads((HERE / f"{mix['text']}.json").read_text())
    return {**text, **mix, "assumed": {**text.get("assumed", {}), **mix.get("assumed", {})}}


def words_per_second(corpus: dict) -> float:
    return corpus["words"] / corpus["seconds"]


def frames_per_word(corpus: dict) -> float:
    """The corpus's speaking rate in mel frames a written word."""
    return FRAME_RATE / words_per_second(corpus)


def _rate(lo: float, hi: float, mean: float) -> float:
    """The rate ``r`` of the density ``exp(r x)`` on [lo, hi] whose mean is
    ``mean`` (the maximum-entropy density with that support and mean)."""
    span = hi - lo

    def mean_of(r):
        if abs(r * span) < 1e-9:
            return lo + span / 2
        return lo + span / -math.expm1(-r * span) - 1 / r

    a, b = -100.0 / span, 100.0 / span
    for _ in range(200):
        mid = (a + b) / 2
        a, b = (mid, b) if mean_of(mid) < mean else (a, mid)
    return (a + b) / 2


def block_seconds(corpus: dict, block: int) -> list:
    """The ``block`` sentence lengths in seconds that every block holds."""
    lo, hi = corpus["min_seconds"], corpus["max_seconds"]
    r = _rate(lo, hi, corpus["seconds"] / corpus["clips"])
    return [lo + math.log1p((i + 0.5) / block * math.expm1(r * (hi - lo))) / r
            for i in range(block)]


def block_lengths(corpus: dict, block: int) -> list:
    """The ``block`` sentence lengths in words that every block holds."""
    rate = words_per_second(corpus)
    return [max(1, round(s * rate)) for s in block_seconds(corpus, block)]


def text(mix: dict, count_phones) -> list:
    """The mix's fixed text, block by block: [(sentence, phones)]."""
    rng = random.Random(mix["text_seed"])
    vocab = (HERE / mix["word_list"]).read_text().split()
    lengths = block_lengths(mix["corpus"], mix["block"])
    comma_share, ends = mix["assumed"]["comma_share"], mix["assumed"]["ends"]
    out = []
    for _ in range(mix["blocks"]):
        for n in lengths:
            words = [rng.choice(vocab) for _ in range(n)]
            end = rng.choice(ends)
            commas = [i < n - 1 and rng.random() < comma_share for i in range(n)]
            while True:
                sentence = " ".join(w + ("," if c else "") for w, c in zip(words, commas))
                sentence = sentence[0].upper() + sentence[1:] + end
                phones = count_phones(sentence)
                if phones <= mix["max_phones"] or len(words) == 1:
                    break
                words.pop()
            out.append((sentence, phones))
    return out


def sentences(mix: dict, seed: int, count_phones) -> list:
    """The mix's text with each block's sentences in the order ``seed``
    draws: [(sentence, phones)]."""
    rng = random.Random(seed)
    fixed = text(mix, count_phones)
    out = []
    for k in range(0, len(fixed), mix["block"]):
        block = fixed[k:k + mix["block"]]
        rng.shuffle(block)
        out += block
    return out
