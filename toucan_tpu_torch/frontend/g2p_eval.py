"""Quantitative G2P accuracy against a curated gold fixture.

A copy of ``toucan_tpu/frontend/g2p_eval.py`` over the port's own frontend
copies (only the import prefix differs).  It scores every first-party G2P
path (en / 15 rule+transducer languages) against hand-checked dictionary
IPA (``tests/data/g2p_eval.json``) and reports per-language word accuracy
and phone error rate (PER, Levenshtein over IPA characters).  The measured
numbers and known systematic gaps live in ``G2P.md``; the fixture encodes
dictionary truth, not the system's output.  ``python -m
toucan_tpu_torch.frontend.g2p_eval`` prints the table.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Tuple

# marks ignored for the stress-agnostic PER (stress placement is scored
# separately via word accuracy)
_STRESS_MARKS = "ˈˌ"


def _phones(ipa: str, keep_stress: bool) -> List[str]:
    """IPA string -> comparable symbol list (NFD so combining marks attach
    deterministically; spaces/marks filtered)."""
    ipa = unicodedata.normalize("NFD", ipa.strip())
    out = []
    for ch in ipa:
        if ch.isspace():
            continue
        if ch in _STRESS_MARKS and not keep_stress:
            continue
        if unicodedata.combining(ch) and out:
            out[-1] += ch  # tie nasal tilde / length to the base symbol
        else:
            out.append(ch)
    return out


def _levenshtein(a: List[str], b: List[str]) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def default_fixture_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "tests", "data",
        "g2p_eval.json")


def phonemize_word(word: str, lang: str) -> str:
    if lang == "en":
        from toucan_tpu_torch.frontend.g2p_en import phonemize_english
        return phonemize_english(word)
    if lang == "cmn":
        from toucan_tpu_torch.frontend.g2p_cmn import hanzi_to_pinyin, pinyin_to_ipa
        return pinyin_to_ipa(hanzi_to_pinyin(word))
    from toucan_tpu_torch.frontend.g2p_rules import phonemize_rules
    return phonemize_rules(word, lang)


def evaluate(fixture_path: str = None) -> Dict[str, dict]:
    """-> {lang: {word_accuracy, per, n_words, errors: [(word, got, gold)]}}.

    ``word_accuracy``: exact-match rate including stress marks.
    ``per``: stress-agnostic phone error rate (edit distance / gold length).
    """
    with open(fixture_path or default_fixture_path(), encoding="utf-8") as f:
        data = json.load(f)
    results = {}
    for lang, pairs in data.items():
        if lang.startswith("_"):
            continue
        exact = 0
        edits = 0
        gold_len = 0
        errors: List[Tuple[str, str, str]] = []
        for word, gold in pairs:
            got = phonemize_word(word, lang).strip()
            # NFD: precomposed vs combining nasal/length marks are equal
            if unicodedata.normalize("NFD", got) == \
                    unicodedata.normalize("NFD", gold):
                exact += 1
            else:
                errors.append((word, got, gold))
            e = _levenshtein(_phones(got, False), _phones(gold, False))
            edits += e
            gold_len += len(_phones(gold, False))
        results[lang] = {
            "word_accuracy": round(exact / len(pairs), 3),
            "per": round(edits / max(gold_len, 1), 3),
            "n_words": len(pairs),
            "errors": errors,
        }
    return results


def main():
    results = evaluate()
    total_w = sum(r["n_words"] for r in results.values())
    total_acc = sum(r["word_accuracy"] * r["n_words"]
                    for r in results.values()) / total_w
    print(f"{'lang':6} {'words':>5} {'word-acc':>8} {'PER':>6}")
    for lang in sorted(results):
        r = results[lang]
        print(f"{lang:6} {r['n_words']:5d} {r['word_accuracy']:8.1%} "
              f"{r['per']:6.1%}")
    print(f"{'all':6} {total_w:5d} {total_acc:8.1%}")
    for lang in sorted(results):
        for word, got, gold in results[lang]["errors"]:
            print(f"  {lang}: {word}: got {got!r} gold {gold!r}")


if __name__ == "__main__":
    main()
