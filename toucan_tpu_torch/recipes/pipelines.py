"""Training recipes: the entry points of this slice.

Counterpart of part of ``toucan_tpu/recipes/pipelines.py``:

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

Both run on the card unless ``device="cpu"`` is passed.  With ``n_data``
/ ``n_model`` (JAX's ``mesh=`` branches) every rank of a process group
(``dist.initialize_distributed``) calls them: ``_mesh`` makes the
('data', 'model') mesh, each data rank samples its 1/n of the global batch
with its own seed (``seed + 7919 * data rank``, which seeds its dropout
too: ``dist/tensor_parallel.py::seed_dropout``), the steps are the sharded
ones (``make_sharded_vocoder_steps``, ``make_sharded_aligner_step``), and
the vocoder's checkpoints are sharded ones
(``train/sharded_checkpointing.py``, one directory per step).
"""

from __future__ import annotations

import os

import numpy as np

from toucan_tpu_torch.data import corpus_recipes


CHECKPOINT_EVERY = 5000  # vocoder steps between checkpoints


def models_dir() -> str:
    return os.environ.get("TOUCAN_MODELS_DIR", "Models")


def _mesh(n_data, n_model, device_type="cpu"):
    """The ('data', 'model') mesh of the process group, or None for
    (None, 1): one process."""
    if (n_data, n_model) == (None, 1):
        return None
    from toucan_tpu_torch.dist.mesh import make_mesh
    return make_mesh(n_data=n_data, n_model=n_model, device_type=device_type)


def _local_share(batch_size, seed, mesh):
    """(this rank's batch size, its sampling seed): JAX's multi-process rule."""
    if mesh is None:
        return batch_size, seed
    n = mesh.size(0)
    assert batch_size % n == 0, f"global batch {batch_size} must divide over {n} data ranks"
    return batch_size // n, seed + 7919 * mesh.get_local_rank("data")


def _vocoder_pipeline(model_name, generator, steps=1_500_000, batch_size=18,
                      generator_warmup=30_000, model_dir=None, seed=131714, device=None,
                      discriminator=None, callbacks=(), n_data=None, n_model=1, **_):
    """The GAN loop; returns the train state.  ``discriminator`` defaults
    to the full-width ``AvocodoJointDiscriminator()`` drawn from ``seed``;
    each callback gets (step, metrics) after every step."""
    import torch

    from toucan_tpu_torch.data.prefetch import DevicePrefetcher
    from toucan_tpu_torch.data.vocoder_data import VocoderDataset
    from toucan_tpu_torch.train.checkpointing import delete_old_checkpoints
    from toucan_tpu_torch.train.sharded_checkpointing import save_sharded_checkpoint
    from toucan_tpu_torch.train.vocoder_train import (checkpoint_payload,
                                                      create_vocoder_train_state,
                                                      make_sharded_vocoder_steps,
                                                      make_vocoder_train_step)
    from toucan_tpu_torch.utils.device import matmul_precision, resolve_device

    paths = []
    for name in ["nancy", "ljspeech", "libritts"]:
        try:
            paths += list(corpus_recipes.build_path_to_transcript_dict(name))
        except FileNotFoundError:
            continue
    device = resolve_device(device)
    state = create_vocoder_train_state(generator=generator, discriminator=discriminator,
                                       device=device, seed=seed)
    mesh = _mesh(n_data, n_model, device.type)
    local_bs, data_seed = _local_share(batch_size, seed, mesh)
    dataset = VocoderDataset(paths, seed=data_seed)
    if mesh is not None:
        warm, adv_step, state = make_sharded_vocoder_steps(state, mesh)
        warm_step = lambda s, b, _update: warm(s, b)  # noqa: E731
    else:
        warm_step = make_vocoder_train_step(use_adversarial=False)
        adv_step = make_vocoder_train_step(use_adversarial=True)
    save_dir = model_dir or os.path.join(models_dir(), model_name)
    os.makedirs(save_dir, exist_ok=True)

    def sample_forever():
        while True:
            yield dataset.sample_batch(local_bs)

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
                if s % CHECKPOINT_EVERY == 0 and mesh is not None:
                    save_sharded_checkpoint(save_dir, state, s)
                elif s % CHECKPOINT_EVERY == 0:
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
                      callbacks=(), mesh=None):
    """The aligner's training loop (JAX ``_aligner_train_fn``): batches of
    ``min(8, len(datapoints))`` drawn with replacement by a
    ``RandomState(seed)``.  Returns the train state; its ``asr`` is the
    trained aligner (``asr.state_dict()`` is a reference ``asr_model``).
    With a ``mesh`` every rank calls it with the same datapoints: the
    default batch rounds to a multiple of the data ranks, each samples its
    share padded to the datapoints' widest (``pad_to``), and the step is
    ``make_sharded_aligner_step``."""
    from toucan_tpu_torch.data.batching import _ceil_to
    from toucan_tpu_torch.data.prefetch import to_tensors
    from toucan_tpu_torch.frontend.inventory import vectors_to_ctc_ids
    from toucan_tpu_torch.train.aligner_train import (create_aligner_train_state,
                                                      make_aligner_train_step,
                                                      make_sharded_aligner_step)
    from toucan_tpu_torch.utils.device import matmul_precision, resolve_device

    device = resolve_device(device)
    state = create_aligner_train_state(device=device)
    n = 1 if mesh is None else mesh.size(0)
    batch_size = batch_size or max(n, min(8, len(datapoints)) // n * n)
    if mesh is None:
        step = make_aligner_train_step()
    else:
        from toucan_tpu_torch.dist.tensor_parallel import seed_dropout

        step, state = make_sharded_aligner_step(state, mesh)
        seed_dropout(state.asr, mesh, seed)   # each data rank's masks its own
        pad_to = pad_to or (
            _ceil_to(max(len(vectors_to_ctc_ids(np.asarray(d["text"]))) for d in datapoints), 8),
            _ceil_to(max(len(d["mel"]) for d in datapoints), 64))
    batch_size, seed = _local_share(batch_size, seed, mesh)
    rng = np.random.RandomState(seed)
    with matmul_precision("float32"):
        for s in range(steps):
            chosen = [datapoints[i] for i in rng.choice(len(datapoints), batch_size)]
            metrics = step(state, to_tensors(aligner_batch(chosen, pad_to), device))
            for callback in callbacks:
                callback(s, metrics)
    return state
