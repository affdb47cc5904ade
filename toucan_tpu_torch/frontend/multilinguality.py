"""Language-similarity metadata (``Preprocessing/multilinguality/``).

A copy of ``toucan_tpu/frontend/multilinguality.py``, reading its own copy
of the JSON assets under ``data/multilinguality/``.

ISO-639-3 metadata (full names, coordinates, family memberships — data
assets shared with the reference) drive two similarity measures used to
pick related supervision languages for low-resource targets:

* tree distance: size of the shared language-family membership set
  (pairs sharing fewer than 2 memberships are pruned);
* map distance: L1 distance between representative coordinates.

Unlike the reference (which materializes all ~2M pair distances into JSON
caches on first run), distances here are computed lazily per query — the
same numbers without the cache files.
"""

from __future__ import annotations

import functools
import json
import os

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data", "multilinguality")


@functools.lru_cache(maxsize=None)
def _load(name: str) -> dict:
    with open(os.path.join(_DATA_DIR, name), "r", encoding="utf8") as f:
        return json.load(f)


def iso_to_fullname() -> dict:
    # sign languages are excluded, as in the reference (SimilaritySolver:12-19)
    return {k: v for k, v in _load("iso_to_fullname.json").items()
            if "Sign Language" not in v}


def iso_to_memberships() -> dict:
    return _load("iso_to_memberships.json")


def iso_to_long_lat() -> dict:
    return _load("iso_to_long_lat.json")


class SimilaritySolver:
    def __init__(self):
        self.fullnames = iso_to_fullname()
        self.memberships = iso_to_memberships()
        self.coords = iso_to_long_lat()

    def tree_dist(self, lang_1: str, lang_2: str) -> int:
        try:
            shared = set(self.memberships[lang_1]) & set(self.memberships[lang_2])
        except KeyError:
            return 0
        return len(shared)

    def map_dist(self, lang_1: str, lang_2: str):
        try:
            lo1, la1 = self.coords[lang_1]
            lo2, la2 = self.coords[lang_2]
        except KeyError:
            return None
        return abs((lo1 - lo2) + (la1 - la2))  # reference's signed-sum metric

    def find_closest_in_family(self, lang: str, supervised_langs, n_closest: int = 5,
                               verbose: bool = False):
        scores = {}
        for cand in supervised_langs:
            d = self.tree_dist(lang, cand)
            if d >= 2:  # reference prunes pairs sharing < 2 memberships
                scores[cand] = d
        results = sorted(scores, key=scores.get, reverse=True)[:n_closest]
        if verbose:
            print(f"{n_closest} most similar languages to "
                  f"{self.fullnames.get(lang, lang)}: "
                  f"{[self.fullnames.get(r, r) for r in results]}")
        return results

    def find_closest_on_map(self, lang: str, n_closest: int = 5,
                            candidates=None, verbose: bool = False):
        scores = {}
        for cand in (candidates or self.coords):
            if cand == lang:
                continue
            d = self.map_dist(lang, cand)
            if d is not None:
                scores[cand] = d
        results = sorted(scores, key=scores.get)[:n_closest]
        if verbose:
            print(f"{n_closest} closest languages to "
                  f"{self.fullnames.get(lang, lang)} on the map: "
                  f"{[self.fullnames.get(r, r) for r in results]}")
        return results
