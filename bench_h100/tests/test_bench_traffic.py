"""The traffic generator: deterministic by seed, the same lengths in every
block whatever the seed, and the corpus's lengths: LJSpeech's mean seconds
and words a clip within its shortest and longest clip, and its characters
a word."""

import statistics

import pytest

from bench_h100.reference.frontend.text import TextFrontend
from bench_h100.traffic import generator

FRONTEND = TextFrontend(language="en", use_g2p=True)


def count(text):
    return len(FRONTEND.string_to_features(text))


@pytest.fixture(scope="module", params=["interactive", "read_aloud"])
def mix(request):
    return dict(generator.load_mix(request.param), blocks=6)


def test_mixes_share_their_text():
    a, b = generator.load_mix("interactive"), generator.load_mix("read_aloud")
    assert a["text"] == b["text"]
    assert {k: v for k, v in a.items() if k != "client"} == \
        {k: v for k, v in b.items() if k not in ("client", "page")}


def test_same_seed_same_sentences(mix):
    assert generator.sentences(mix, 2**31 + 9, count) == generator.sentences(mix, 2**31 + 9, count)


def test_seeds_differ_in_order_not_in_work(mix):
    a = generator.sentences(mix, 3_000_000_001, count)
    b = generator.sentences(mix, 3_000_000_002, count)
    assert a != b
    for k in range(0, len(a), mix["block"]):
        assert sorted(a[k:k + mix["block"]]) == sorted(b[k:k + mix["block"]])


def test_blocks_hold_the_stated_lengths(mix):
    lengths = sorted(generator.block_lengths(mix["corpus"], mix["block"]))
    text = generator.text(mix, count)
    for k in range(0, len(text), mix["block"]):
        words = sorted(len(t.split()) for t, _ in text[k:k + mix["block"]])
        # a sentence loses words only where its phones pass the limit
        assert all(w <= n for w, n in zip(words, lengths))
    total = sum(len(t.split()) for t, _ in text)
    assert total >= 0.97 * sum(lengths) * mix["blocks"]


def test_lengths_follow_the_corpus(mix):
    c = mix["corpus"]
    seconds = generator.block_seconds(c, mix["block"])
    assert c["min_seconds"] < min(seconds) and max(seconds) < c["max_seconds"]
    assert statistics.mean(seconds) == pytest.approx(c["seconds"] / c["clips"], rel=0.01)
    words = generator.block_lengths(c, mix["block"])
    assert statistics.mean(words) == pytest.approx(c["words"] / c["clips"], rel=0.02)
    # a maximum-entropy density with a mean above the midpoint rises: more
    # long clips than short ones, as in the corpus
    assert seconds[-1] - seconds[-2] < seconds[1] - seconds[0]
    text = generator.text(mix, count)
    chars = sum(len(t) for t, _ in text) / sum(len(t.split()) for t, _ in text)
    assert chars == pytest.approx(c["characters"] / c["words"], rel=0.05)


def test_phones(mix):
    sents = generator.sentences(mix, 77, count)
    phones = [p for _, p in sents]
    assert max(phones) <= mix["max_phones"] and min(phones) >= 10
    assert 90 <= statistics.mean(phones) <= 110
    assert [count(t) for t, _ in sents[:16]] == phones[:16]


def test_the_text_exercises_the_normaliser(mix):
    text = " ".join(t for t, _ in generator.sentences(mix, 5, count))
    assert any(c.isdigit() for c in text) and "," in text and "$" in text
