"""Training observability: progress spectrogram plots and logging callbacks.

Counterpart of ``toucan_tpu/train/visualization.py`` (the reference's
per-epoch progress plots, ``Utility/utils.py:196-288`` plot_progress_spec,
and its optional wandb logging, ``toucantts_train_loop.py:181-211``).
matplotlib and wandb are optional: without matplotlib the plot returns
None, without wandb its callback does nothing.  The plot runs
``ToucanTTS.infer`` on the model's device; the glow runs where the config
has one, with zero noise (the port's ``infer`` has no switch for it).
"""

from __future__ import annotations

import os

import numpy as np
import torch

FALLBACK_PHONES = "~ðɪs ɪz ə tˈɛst~#"


@torch.no_grad()
def plot_progress_spec(model, save_dir: str, step: int, frontend, sentence: str = None,
                       default_embedding=None, lang_id=None, input_is_phones: bool = False,
                       max_frames: int = 2048):
    """Synthesize the language's example sentence and save the mel before
    and after the PostNet (and glow) as PNGs.  Returns (before_path,
    after_path), or None without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    sentence = sentence or frontend.get_example_sentence(frontend.language) or FALLBACK_PHONES
    try:
        phones = frontend.string_to_features(sentence, input_phonemes=input_is_phones)
    except RuntimeError:  # no G2P backend: the fallback IPA sentence
        phones = frontend.string_to_features(FALLBACK_PHONES, input_phonemes=True)
    device = next(model.parameters()).device
    utt = None if default_embedding is None else torch.as_tensor(
        np.asarray(default_embedding, np.float32)[None], device=device)
    lang = None if lang_id is None else torch.tensor([[lang_id]], device=device)
    before, after, *_ = model.infer(torch.as_tensor(phones[None], device=device),
                                    torch.tensor([len(phones)], device=device), max_frames,
                                    utterance_embedding=utt, lang_ids=lang)
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for name, mel in (("before", before), ("after", after)):
        fig, ax = plt.subplots(figsize=(9, 4))
        ax.imshow(mel[0].float().cpu().numpy().T, aspect="auto", origin="lower", cmap="GnBu")
        ax.set_title(f"step {step} ({name} postflow)")
        path = os.path.join(save_dir, f"progress_{name}_{step}.png")
        fig.savefig(path)
        plt.close(fig)
        paths.append(path)
    return tuple(paths)


def console_callback(step: int, metrics: dict):
    """Print one line of the step's metrics (floats or 0-d tensors)."""
    parts = "  ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
    print(f"[step {step}] {parts}")


def wandb_callback(step: int, metrics: dict):
    """Log the metrics to wandb where it is installed."""
    try:
        import wandb
    except ImportError:
        return
    wandb.log({k: float(v) for k, v in metrics.items()}, step=step)
