"""Training recipes: the entry points of this slice.

Counterpart of part of ``toucan_tpu/recipes/pipelines.py``, single
process (the ``mesh=`` branches wait for the distribution slice):

* ``avocodo_pipeline`` and ``bigvgan_pipeline`` (``_vocoder_pipeline``):
  the vocoder GAN loop over the wave files of the nancy, ljspeech and
  libritts recipes under ``TOUCAN_CORPORA_ROOT``; mel-only warm-up while
  ``step <= generator_warmup + 100``, then adversarial steps with the
  critic updating at every third; a checkpoint every 5000 steps, named by
  the step before it, the five newest kept.  A checkpoint is a ``.pt`` that
  ``load.py::load_vocoder`` reads (the generator's state dict under
  ``generator``) and that resumes a run
  (``train/vocoder_train.py::checkpoint_payload``);
* ``_aligner_train_fn``: the aligner's training loop on datapoints.

Both run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import os

import numpy as np

from toucan_tpu_torch.data import corpus_recipes


CHECKPOINT_EVERY = 5000  # vocoder steps between checkpoints


def models_dir() -> str:
    return os.environ.get("TOUCAN_MODELS_DIR", "Models")


def _vocoder_pipeline(model_name, generator, steps=1_500_000, batch_size=18,
                      generator_warmup=30_000, model_dir=None, seed=131714, device=None,
                      discriminator=None, callbacks=(), **_):
    """The GAN loop; returns the train state.  ``discriminator`` defaults
    to the full-width ``AvocodoJointDiscriminator()`` drawn from ``seed``;
    each callback gets (step, metrics) after every step."""
    import torch

    from toucan_tpu_torch.data.prefetch import DevicePrefetcher
    from toucan_tpu_torch.data.vocoder_data import VocoderDataset
    from toucan_tpu_torch.train.checkpointing import delete_old_checkpoints
    from toucan_tpu_torch.train.vocoder_train import (checkpoint_payload,
                                                      create_vocoder_train_state,
                                                      make_vocoder_train_step)
    from toucan_tpu_torch.utils.device import matmul_precision, resolve_device

    paths = []
    for name in ["nancy", "ljspeech", "libritts"]:
        try:
            paths += list(corpus_recipes.build_path_to_transcript_dict(name))
        except FileNotFoundError:
            continue
    device = resolve_device(device)
    dataset = VocoderDataset(paths, seed=seed)
    state = create_vocoder_train_state(generator=generator, discriminator=discriminator,
                                       device=device, seed=seed)
    warm_step = make_vocoder_train_step(use_adversarial=False)
    adv_step = make_vocoder_train_step(use_adversarial=True)
    save_dir = model_dir or os.path.join(models_dir(), model_name)
    os.makedirs(save_dir, exist_ok=True)

    def sample_forever():
        while True:
            yield dataset.sample_batch(batch_size)

    # loading and segmenting batch N+1 overlaps step N (the reference's
    # DataLoader workers); see data/prefetch.py
    prefetcher = DevicePrefetcher(sample_forever(), device, depth=2)
    try:
        with matmul_precision("float32"):
            for batch in prefetcher:
                s = state.step
                if s >= steps:
                    break
                if s <= generator_warmup + 100:
                    metrics = warm_step(state, batch, False)
                else:
                    metrics = adv_step(state, batch, s % 3 == 0)
                for callback in callbacks:
                    callback(s, metrics)
                if s % CHECKPOINT_EVERY == 0:
                    torch.save(checkpoint_payload(state),
                               os.path.join(save_dir, f"checkpoint_{s}.pt"))
                    delete_old_checkpoints(save_dir, keep=5)
    finally:
        prefetcher.close()
    return state


def avocodo_pipeline(**kw):
    from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
    return _vocoder_pipeline("Avocodo", HiFiGANGenerator(), **kw)


def bigvgan_pipeline(**kw):
    from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
    return _vocoder_pipeline("BigVGAN", BigVGAN(), **kw)


def aligner_batch(chosen, pad_to=None):
    """Datapoints (``text`` (T, 62), ``mel`` (L, 80), optional
    ``speaker_embedding`` (192,)) -> the aligner step's host batch, tokens
    padded to a multiple of 8 and frames of 64 (or to ``pad_to``)."""
    from toucan_tpu_torch.data.batching import _ceil_to
    from toucan_tpu_torch.frontend.inventory import vectors_to_ctc_ids

    tokens = [vectors_to_ctc_ids(np.asarray(d["text"])) for d in chosen]
    tmax = pad_to[0] if pad_to else _ceil_to(max(len(t) for t in tokens), 8)
    lmax = pad_to[1] if pad_to else _ceil_to(max(len(d["mel"]) for d in chosen), 64)
    b = len(chosen)
    batch = dict(
        mel=np.zeros((b, lmax, 80), np.float32),
        mel_lengths=np.asarray([len(d["mel"]) for d in chosen], np.int32),
        tokens=np.zeros((b, tmax), np.int32),
        token_lengths=np.asarray([len(t) for t in tokens], np.int32),
        speaker_embeddings=np.stack([d.get("speaker_embedding", np.zeros(192, np.float32))
                                     for d in chosen]).astype(np.float32),
    )
    for i, d in enumerate(chosen):
        batch["mel"][i, :len(d["mel"])] = d["mel"]
        batch["tokens"][i, :len(tokens[i])] = tokens[i]
    return batch


def _aligner_train_fn(datapoints, steps, batch_size=None, pad_to=None, device=None, seed=0,
                      callbacks=()):
    """The aligner's training loop (JAX ``_aligner_train_fn``, one process):
    batches of ``min(8, len(datapoints))`` drawn with replacement by a
    ``RandomState(seed)``.  Returns the train state; its ``asr`` is the
    trained aligner (``asr.state_dict()`` is a reference ``asr_model``)."""
    from toucan_tpu_torch.data.prefetch import to_tensors
    from toucan_tpu_torch.train.aligner_train import (create_aligner_train_state,
                                                      make_aligner_train_step)
    from toucan_tpu_torch.utils.device import matmul_precision, resolve_device

    device = resolve_device(device)
    state = create_aligner_train_state(device=device)
    step = make_aligner_train_step()
    batch_size = batch_size or min(8, len(datapoints))
    rng = np.random.RandomState(seed)
    with matmul_precision("float32"):
        for s in range(steps):
            chosen = [datapoints[i] for i in rng.choice(len(datapoints), batch_size)]
            metrics = step(state, to_tensors(aligner_batch(chosen, pad_to), device))
            for callback in callbacks:
                callback(s, metrics)
    return state
