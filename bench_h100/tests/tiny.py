"""Tiny configurations and mixes for running the harness on the CPU."""

import copy
import json
from pathlib import Path

from bench_h100.traffic import generator

BENCH = Path(__file__).resolve().parent.parent

TINY_ACOUSTIC = dict(adim=32, aheads=2, enc_layers=1, enc_units=64, dec_layers=1, dec_units=64,
                     duration_chans=32, pitch_chans=32, pitch_layers=2, energy_chans=32,
                     glow_blocks=2, glow_hidden=32, glow_layers=2, lang_embs=100)


def config(name: str) -> dict:
    """A configuration of the benchmark at tiny widths (the CPU tests only)."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["acoustic"].update(TINY_ACOUSTIC)
    cfg["vocoder_config"]["channels"] = 32
    return cfg


# sentences of 3 to 9 words, 2.5 words a second
TINY_CORPUS = dict(clips=1, words=5, characters=29, seconds=2.0, min_seconds=1.0, max_seconds=3.6)


def mix(name: str, **changes) -> dict:
    m = generator.load_mix(name)
    m.update(dict(block=4, blocks=2, corpus=TINY_CORPUS), **changes)
    if "page" in m:
        m["page"] = 4
    return m
