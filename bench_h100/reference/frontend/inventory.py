"""Articulatory phone inventory.

The inventory (phone -> phonological features, feature -> vector index,
phone -> CTC id) lives in ``data/articulatory_inventory.json``.  The data
matches the reference toolkit's tables (see
``Preprocessing/articulatory_features.py:25-953``) so that
feature vectors and aligner CTC ids are bit-identical across frameworks —
the *data* is a fact of the IPA; only the representation here is ours.

Vector layout (62 dims):
  dims 0-12   contextual modifiers (stress, five tone registers, four tone
              contours, three length marks) — set by the text frontend from
              the characters surrounding a phone, never from this table.
  dims 13-61  lexical features of the phone itself (category, place,
              tongue position, openness, rounding, manner, voicing).
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "articulatory_inventory.json")

NUM_FEATURES = 62
NUM_MODIFIER_FEATURES = 13  # dims 0..12 are contextual, not lexical

# The CTC aligner reserves headroom above the currently-assigned phone ids
# (reference: Aligner num_symbols=145, blank=144; ids currently occupy 0..110).
NUM_CTC_SYMBOLS = 145
CTC_BLANK_ID = 144


@functools.lru_cache(maxsize=1)
def _raw() -> dict:
    with open(_DATA_PATH, "r") as f:
        return json.load(f)


@functools.lru_cache(maxsize=1)
def feature_index() -> dict:
    """Feature-value name -> dimension index in the 62-dim vector."""
    return dict(_raw()["feature_to_index"])


@functools.lru_cache(maxsize=1)
def phone_ids() -> dict:
    """IPA character -> integer id for CTC alignment states."""
    return dict(_raw()["phone_to_id"])


@functools.lru_cache(maxsize=1)
def id_to_phone() -> dict:
    return {v: k for k, v in phone_ids().items()}


@functools.lru_cache(maxsize=1)
def phone_vectors() -> dict:
    """IPA character -> 62-dim binary feature list (lexical dims only set)."""
    f2i = feature_index()
    table = {}
    for phone, feats in _raw()["phone_features"].items():
        if len(phone) != 1:
            continue
        vec = [0] * NUM_FEATURES
        for value in feats.values():
            if value in f2i:
                vec[f2i[value]] = 1
        table[phone] = vec
    return table


@functools.lru_cache(maxsize=1)
def phone_feature_matrix() -> np.ndarray:
    """(num_phones, 62) matrix ordered by CTC phone id.

    Row i is the lexical feature vector of the phone whose id is i; used to
    map feature-vector sequences back to CTC id sequences without a Python
    scan over the table (reference does a linear search per token at
    ``TextFrontend.py:445-461``).
    """
    p2id = phone_ids()
    vecs = phone_vectors()
    mat = np.zeros((max(p2id.values()) + 1, NUM_FEATURES), dtype=np.int32)
    for phone, pid in p2id.items():
        if phone in vecs:
            mat[pid] = np.asarray(vecs[phone], dtype=np.int32)
    return mat


def vectors_to_ctc_ids(feature_vectors: np.ndarray) -> list:
    """Convert a (T, 62) articulatory feature array to CTC phone ids.

    Matches the reference semantics (``TextFrontend.py:445-461``): word
    boundaries are dropped (absent in audio), nasalized vowels collapse to
    their oral counterpart, and only the 49 lexical dims (13:) participate
    in the lookup.  Vectorized: one (T, P) comparison instead of a per-token
    linear search.
    """
    f2i = feature_index()
    vecs = np.asarray(feature_vectors, dtype=np.int32).copy()
    keep = vecs[:, f2i["word-boundary"]] == 0
    vecs = vecs[keep]
    vowel_nasal = (vecs[:, f2i["vowel"]] == 1) & (vecs[:, f2i["nasal"]] == 1)
    vecs[vowel_nasal, f2i["nasal"]] = 0
    lex = vecs[:, NUM_MODIFIER_FEATURES:]
    table = phone_feature_matrix()[:, NUM_MODIFIER_FEATURES:]
    # (T, P): exact match of lexical features against every phone row
    match = (lex[:, None, :] == table[None, :, :]).all(-1)
    ids = []
    for row in match:
        hits = np.flatnonzero(row)
        if hits.size:
            ids.append(int(hits[0]))
    return ids
