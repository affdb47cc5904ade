"""The scripts of the repository's root, driving the port.

Each module is the twin of a root script and runs with ``python -m
toucan_tpu_torch.run.<name>``: serving (``run_text_to_file_reader.py``,
``run_prosody_override.py``, ``run_interactive_demo.py``,
``run_controllable_GUI.py``), training (``run_training_pipeline.py``, the
CLI of ``toucan_tpu_torch/cli.py``), checkpoint averaging
(``run_weight_averaging.py``) and data scoring (``run_scorer.py``).
Checkpoints are read from the reference
release's layout under ``TOUCAN_MODELS_DIR`` (default ``Models``), as the
root scripts read them.  Everything runs on the card unless
``--device cpu`` is given; ``--dtype bfloat16`` and ``--matmul_precision
default`` choose the serving dtype and precision policy
(``infer/interface.py``).
"""

from __future__ import annotations

import os

import torch

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def models_dir() -> str:
    return os.environ.get("TOUCAN_MODELS_DIR", "Models")


def model_path(*parts) -> str:
    return os.path.join(models_dir(), *parts)


def add_interface_args(parser, precision: bool = True):
    """--device, and where the script builds an interface --dtype and
    --matmul_precision."""
    parser.add_argument("--device", default=None,
                        help="torch device, e.g. cpu (default: the card)")
    if precision:
        parser.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                            help="compute dtype of the acoustic model and vocoder")
        parser.add_argument("--matmul_precision", choices=("float32", "default"),
                            default="float32", help="precision policy of cuDNN and cuBLAS")


def interface_kwargs(args) -> dict:
    """The interface's keyword arguments of parsed ``add_interface_args``."""
    kw = dict(device=args.device)
    if hasattr(args, "dtype"):
        kw.update(dtype=DTYPES[args.dtype], matmul_precision=args.matmul_precision)
    return kw


def meta_interface(language: str = "en", faster_vocoder: bool = True, **kwargs):
    """The interface of the multilingual ``ToucanTTS_Meta`` checkpoint with
    the Avocodo (HiFiGAN) or BigVGAN vocoder and the GST, as the root
    scripts build it."""
    from toucan_tpu_torch.load import interface_from_torch

    return interface_from_torch(
        model_path("ToucanTTS_Meta", "best.pt"),
        model_path("Avocodo" if faster_vocoder else "BigVGAN", "best.pt"),
        model_path("Embedding", "embedding_function.pt"),
        vocoder_kind="hifigan" if faster_vocoder else "bigvgan", language=language, **kwargs)
