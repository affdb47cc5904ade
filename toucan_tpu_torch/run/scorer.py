"""Data-QA scoring: the twin of ``run_scorer.py``.

    python -m toucan_tpu_torch.run.scorer CACHE.npz [--aligner PATH]
        [--worst 20] [--device cpu]

Loads an aligner or FastSpeech cache (``data/corpus.py::load_cache``; the
JAX package's caches too) and the aligner's reference checkpoint
(``load.py::load_aligner``; default ``Aligner/aligner.pt`` under
``TOUCAN_MODELS_DIR``), scores every utterance by its CTC loss and prints
the worst.
"""

from __future__ import annotations

import argparse

from toucan_tpu_torch.run import add_interface_args, model_path


def main(argv=None):
    from toucan_tpu_torch.data.corpus import load_cache
    from toucan_tpu_torch.data.scorer import AlignmentScorer
    from toucan_tpu_torch.load import load_aligner

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("cache", help="path to an aligner or fastspeech cache (.npz)")
    parser.add_argument("--aligner", default=None,
                        help="aligner checkpoint (default: Aligner/aligner.pt of the models)")
    parser.add_argument("--worst", type=int, default=20)
    add_interface_args(parser, precision=False)
    args = parser.parse_args(argv)

    dataset = load_cache(args.cache)
    scorer = AlignmentScorer(load_aligner(args.aligner or model_path("Aligner", "aligner.pt")),
                             device=args.device)
    scores = scorer.score(dataset)
    print("worst samples by aligner CTC loss:")
    for idx in scorer.worst_n(args.worst):
        print(f"  [{idx}] ctc={scores[idx]:.4f}  {dataset[idx].get('path', '')}")
    return scores


if __name__ == "__main__":
    main()
