"""Checkpoint averaging: the twin of ``run_weight_averaging.py``.

    python -m toucan_tpu_torch.run.weight_averaging [--models_dir DIR] [--n 2]

For every model directory under ``TOUCAN_MODELS_DIR`` (or ``--models_dir``),
the n newest ``checkpoint_<step>.pt`` (``train/checkpointing.py::
list_checkpoints``) are loaded as plain dicts, with no model to load them
into, and averaged by JAX's rule (``run_weight_averaging.py:16-40``):
every floating tensor is the mean over the checkpoints; integer tensors
and everything that is not a tensor come from the newest.  The result is
``best.pt`` in that directory, which ``load.py::load_toucan_tts`` (or
``load_vocoder`` for a vocoder's directory) reads.
"""

from __future__ import annotations

import argparse
import os

import torch

from toucan_tpu_torch.run import models_dir as default_models_dir
from toucan_tpu_torch.train.checkpointing import list_checkpoints


def average_trees(trees):
    """JAX's ``jax.tree.map`` rule over nested dicts, lists and tuples of
    the same structure, oldest first."""
    newest = trees[-1]
    if isinstance(newest, dict):
        return {k: average_trees([t[k] for t in trees]) for k in newest}
    if isinstance(newest, (list, tuple)):
        return type(newest)(average_trees(list(leaves)) for leaves in zip(*trees))
    if isinstance(newest, torch.Tensor) and newest.is_floating_point():
        return torch.stack(trees).mean(0)
    return newest


def make_best_in_all(models_dir=None, n=2):
    models_dir = models_dir or default_models_dir()
    for name in sorted(os.listdir(models_dir)):
        directory = os.path.join(models_dir, name)
        paths = list_checkpoints(directory)[-n:]
        if len(paths) < 1:
            continue
        trees = [torch.load(p, map_location="cpu", weights_only=True) for p in paths]
        out = os.path.join(directory, "best.pt")
        torch.save(average_trees(trees), out)
        print(f"averaged {len(paths)} checkpoints -> {out}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--models_dir", default=None)
    parser.add_argument("--n", type=int, default=2)
    args = parser.parse_args(argv)
    make_best_in_all(args.models_dir, args.n)


if __name__ == "__main__":
    main()
