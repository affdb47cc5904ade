"""Training recipes (``TrainingInterfaces/TrainingPipelines/`` equivalents).

Counterpart of ``toucan_tpu/recipes/pipelines.py``.  Each pipeline
mirrors its reference counterpart's wiring and default hyperparameters:

* the TTS recipes (``nancy_pipeline``, ``stochastic_nancy_pipeline``,
  ``integration_test_pipeline``, ``meta_pipeline``, ``finetuning_example``;
  ``_tts_pipeline``): corpus recipes under ``TOUCAN_CORPORA_ROOT`` feed
  ``data/corpus.py::prepare_fastspeech_corpus`` (caches under
  ``Corpora/<recipe>`` of the working directory, the aligner fine-tuned on
  each corpus by ``_aligner_train_fn``), then ``train/loop.py::train_loop``
  trains mono or meta and writes ``checkpoint_<step>.pt`` (and ``best.pt``
  once SWA starts) into the model directory;
* ``fs_embedding_integration_test_pipeline`` and ``embedding_pipeline``:
  FastSpeech2 co-trained with the GST; they write ``embedding_function.pt``
  (``{"style_emb_func": ...}``);
* ``aligner_pipeline``: the aligner pretrained on a multilingual pool; it
  writes ``Aligner/aligner.pt`` (``{"asr_model": ...}``);
* ``avocodo_pipeline`` and ``bigvgan_pipeline`` (``_vocoder_pipeline``):
  the vocoder GAN loop over the wave files of the nancy, ljspeech and
  libritts recipes; mel-only warm-up while ``step <= generator_warmup +
  100``, then adversarial steps with the critic updating at every third; a
  checkpoint every 5000 steps, named by the step before it, the five newest
  kept.  A checkpoint is a ``.pt`` that ``load.py::load_vocoder`` reads
  (the generator's state dict under ``generator``) and that resumes a run
  (``train/vocoder_train.py::checkpoint_payload``).

Every artefact is a reference ``.pt`` layout that ``load.py`` reads (the
JAX package writes msgpack).  The pipelines run on the card unless
``device="cpu"`` is passed; ``callbacks`` get (step, metrics) after steps.
With ``n_data`` / ``n_model`` (JAX's ``mesh=`` branches) every rank of a
process group (``dist.initialize_distributed``) calls them: ``_mesh``
makes the ('data', 'model') mesh, each data rank samples its 1/n of the
global batch with its own seed (``seed + 7919 * data rank``, which seeds
its dropout too: ``dist/tensor_parallel.py::seed_dropout``), the steps are
the sharded ones (``make_sharded_vocoder_steps``,
``make_sharded_aligner_step``, ``make_train_step(mesh=...)``), and the
vocoder's and the TTS loop's checkpoints are sharded ones
(``train/sharded_checkpointing.py``, one directory per step).
"""

from __future__ import annotations

import os

import numpy as np

from toucan_tpu_torch.data import corpus_recipes


CHECKPOINT_EVERY = 5000  # vocoder steps between checkpoints
GST_SEED = 0             # the GST drawn where no embedding function is on disk


def models_dir() -> str:
    return os.environ.get("TOUCAN_MODELS_DIR", "Models")


def _save(payload: dict, save_dir: str, name: str, mesh=None) -> str:
    """torch.save ``payload`` to ``save_dir/name`` (on rank 0 of a mesh)."""
    import torch

    path = os.path.join(save_dir, name)
    if mesh is None or torch.distributed.get_rank() == 0:
        os.makedirs(save_dir, exist_ok=True)
        torch.save(payload, path)
    return path


def _load_gst_state_dict() -> dict:
    """The frozen style embedding's weights for TTS training: the
    reference's ``Models/Embedding/embedding_function.pt`` where it exists,
    else (with a warning, as JAX's ``_load_gst_variables``) a
    ``StyleEmbedding()`` drawn from ``GST_SEED``."""
    import torch

    from toucan_tpu_torch.load import load_style_embedding
    from toucan_tpu_torch.models.gst import StyleEmbedding

    path = os.path.join(models_dir(), "Embedding", "embedding_function.pt")
    if os.path.exists(path):
        return load_style_embedding(path)
    print(f"warning: no embedding function at {path}; using random init")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(GST_SEED)
        return StyleEmbedding().state_dict()


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


def _prepare_recipe(spec, use_g2p=True, device=None):
    """``spec`` is a recipe name, or ``(name, lang_override)``, or
    ``(name, lang_override, ctc_selection)``."""
    from functools import partial

    from toucan_tpu_torch.data.corpus import prepare_fastspeech_corpus

    name, lang, ctc_selection = spec, None, True
    if isinstance(spec, tuple):
        name, lang = spec[0], spec[1]
        if len(spec) > 2:
            ctc_selection = spec[2]
    lang = lang or corpus_recipes.recipe_language(name)
    mapping = corpus_recipes.build_path_to_transcript_dict(name)
    return prepare_fastspeech_corpus(
        mapping, os.path.join("Corpora", name), lang,
        aligner_train_fn=partial(_aligner_train_fn, device=device), use_g2p=use_g2p,
        ctc_selection=ctc_selection, device=device)


def _tts_pipeline(recipe_names, save_name, steps=80_000, batch_size=24,
                  postnet_start_steps=9000, lr=1e-3, warmup_steps=8000,
                  use_discriminator=True, stochastic=False,
                  resume_checkpoint=None, resume=False, finetune=False,
                  model_dir=None, use_wandb=False, n_data=None, n_model=1,
                  seed=131714, use_g2p=True, config=None, device=None, callbacks=(),
                  log_every=50, **_):
    """``recipe_names``: flat list of recipe specs (one dataset each), or a
    list of lists — each inner list becomes ONE concatenated per-language
    dataset for the meta loop (``ToucanTTS_MetaCheckpoint.py:180-193``).
    Returns ``train_loop``'s (state, history)."""
    from toucan_tpu_torch.train.loop import train_loop
    from toucan_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    save_dir = model_dir or os.path.join(models_dir(), save_name)
    datasets = []
    for entry in recipe_names:
        if isinstance(entry, list):  # per-language group -> ConcatDataset
            group = []
            for spec in entry:
                group += _prepare_recipe(spec, use_g2p=use_g2p, device=device)
            datasets.append(group)
        else:
            datasets.append(_prepare_recipe(entry, use_g2p=use_g2p, device=device))
    return train_loop(datasets if len(datasets) > 1 else datasets[0],
                      _load_gst_state_dict(), save_dir, config=config,
                      batch_size=batch_size, lr=lr,
                      warmup_steps=warmup_steps, steps=steps,
                      postnet_start_steps=postnet_start_steps,
                      use_discriminator=use_discriminator, resume=resume,
                      path_to_checkpoint=resume_checkpoint, fine_tune=finetune,
                      mesh=_mesh(n_data, n_model, device.type), seed=seed, device=device,
                      callbacks=callbacks, log_every=log_every)


def nancy_pipeline(**kw):
    return _tts_pipeline(["nancy"], "ToucanTTS_Nancy", **kw)


def stochastic_nancy_pipeline(**kw):
    # the stochastic variant reuses the same data pipeline and loop, as
    # JAX's does
    return _tts_pipeline(["nancy"], "StochasticToucanTTS_Nancy", **kw)


def integration_test_pipeline(**kw):
    kw.setdefault("steps", 2000)
    kw.setdefault("batch_size", 8)
    kw.setdefault("warmup_steps", 500)
    kw.setdefault("postnet_start_steps", 200)
    return _tts_pipeline(["integration_test"], "ToucanTTS_IntegrationTest", **kw)


META_GROUPS = [
    ["nancy", "ljspeech", "libritts_all_clean", "vctk", "nvidia_hifitts",
     ("RAVDESS", None, False), "ESDS"],                       # en
    ["karlsson", "eva", "hokus", "bernd", "hui_others", "thorsten"],  # de
    ["css10el"],                                              # el
    ["spanish_blizzard_train", "css10es", "mls_spanish"],     # es
    ["css10fi"],                                              # fi
    ["css10ru"],                                              # ru
    ["css10hu"],                                              # hu
    ["css10nl", "mls_dutch"],                                 # nl
    ["siwis_subset", "blizzard2023_ad_silence_removed",
     "blizzard2023_neb_e_silence_removed",
     "blizzard2023_neb_silence_removed", "mls_french"],       # fr
    [("mls_portuguese", "pt-br")],                            # pt-br
    ["mls_polish"],                                           # pl
    ["mls_italian"],                                          # it
    ["css10cmn", "aishell3"],                                 # cmn
    ["vietTTS"],                                              # vi
]


def meta_pipeline(**kw):
    """Massively multilingual checkpoint: the reference's 14 per-language
    ConcatDataset groups over 33 corpora (``ToucanTTS_MetaCheckpoint.py:47-193``),
    incl. the non-Latin G2P languages (cmn via aishell3/css10, vi via VietTTS)
    and Brazilian Portuguese."""
    kw.setdefault("steps", 160_000)
    return _tts_pipeline([list(g) for g in META_GROUPS], "ToucanTTS_Meta", **kw)


def _embedding_loop(state, dataset, steps, batch_size, seed, device, callbacks):
    """The co-training steps of FastSpeech2 and the GST until ``steps``,
    over shuffled drop-last batches of ``dataset``."""
    from toucan_tpu_torch.data.batching import BatchSampler
    from toucan_tpu_torch.data.prefetch import to_tensors
    from toucan_tpu_torch.train.embedding_train import make_embedding_train_step
    from toucan_tpu_torch.utils.device import f32_precision

    sampler = BatchSampler(dataset, batch_size=batch_size, seed=seed)
    if len(sampler) == 0:
        raise ValueError(f"{len(dataset)} datapoints make no batch of {batch_size}")
    step = make_embedding_train_step()
    with f32_precision():
        while state.step < steps:
            for batch in sampler:
                metrics = step(state, to_tensors(batch, device))
                for callback in callbacks:
                    callback(state.step - 1, metrics)
                if state.step >= steps:
                    break
    return state


def fs_embedding_integration_test_pipeline(resume_checkpoint=None, resume=False,
                                           finetune=False, model_dir=None,
                                           use_wandb=False, steps=2000,
                                           batch_size=8, warmup_steps=500,
                                           lr=1e-3, n_data=None, n_model=1,
                                           seed=131714, use_g2p=True,
                                           config=None, device=None, callbacks=(), **_):
    """``fs_it``: embedding-function integration test — co-trains FastSpeech2
    with the GST style embedding on the 500-sample Nancy subset
    (``FastSpeech2Embedding_IntegrationTest.py:44-57``).  Writes
    ``embedding_function.pt``; returns the GST's state dict."""
    from toucan_tpu_torch.train.embedding_train import create_embedding_train_state
    from toucan_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    save_dir = model_dir or os.path.join(models_dir(), "FastSpeech2_IntegrationTest")
    dataset = _prepare_recipe("integration_test", use_g2p=use_g2p, device=device)
    state = create_embedding_train_state(config=config, lr=lr, warmup_steps=warmup_steps,
                                         device=device, seed=seed)
    _embedding_loop(state, dataset, steps, batch_size, seed, device, callbacks)
    gst_sd = state.gst.state_dict()
    _save({"style_emb_func": gst_sd}, save_dir, "embedding_function.pt")
    return gst_sd


def finetuning_example(**kw):
    kw.setdefault("steps", 5000)
    kw.setdefault("lr", 1e-5)
    kw.setdefault("finetune", True)
    return _tts_pipeline(["integration_test"], "ToucanTTS_FineTuningExample", **kw)


def aligner_pipeline(resume_checkpoint=None, resume=False, finetune=False,
                     model_dir=None, steps=500_000, n_data=None, n_model=1,
                     seed=131714, use_g2p=True, device=None, callbacks=(), **_):
    """The aligner pretrained on the nancy, ljspeech, thorsten, css10fr and
    css10es corpora that exist; writes ``aligner.pt`` and returns the
    aligner's state dict."""
    from toucan_tpu_torch.data.corpus import build_aligner_cache
    from toucan_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    datapoints = []
    for name in ["nancy", "ljspeech", "thorsten", "css10fr", "css10es"]:
        try:
            mapping = corpus_recipes.build_path_to_transcript_dict(name)
        except FileNotFoundError:
            continue
        lang = corpus_recipes.recipe_language(name)
        datapoints += build_aligner_cache(mapping, os.path.join("Corpora", name), lang,
                                          use_g2p=use_g2p, device=device)
    mesh = _mesh(n_data, n_model, device.type)
    state = _aligner_train_fn(datapoints, steps, mesh=mesh, device=device, callbacks=callbacks)
    asr_sd = state.asr.state_dict()
    _save({"asr_model": asr_sd}, model_dir or os.path.join(models_dir(), "Aligner"),
          "aligner.pt", mesh)
    return asr_sd


def embedding_pipeline(model_dir=None, steps=100_000, n_data=None, n_model=1,
                       seed=131714, use_g2p=True, device=None, callbacks=(), **_):
    """The GST co-trained with FastSpeech2 on the nancy and libritts corpora
    that exist, batch 16; writes ``embedding_function.pt`` and returns the
    GST's state dict."""
    from functools import partial

    from toucan_tpu_torch.data.corpus import prepare_fastspeech_corpus
    from toucan_tpu_torch.train.embedding_train import create_embedding_train_state
    from toucan_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    state = create_embedding_train_state(device=device, seed=seed)
    dataset = []
    for name in ["nancy", "libritts"]:
        try:
            mapping = corpus_recipes.build_path_to_transcript_dict(name)
        except FileNotFoundError:
            continue
        lang = corpus_recipes.recipe_language(name)
        dataset += prepare_fastspeech_corpus(
            mapping, os.path.join("Corpora", name), lang, use_g2p=use_g2p, device=device,
            aligner_train_fn=partial(_aligner_train_fn, device=device))
    _embedding_loop(state, dataset, steps, 16, seed, device, callbacks)
    gst_sd = state.gst.state_dict()
    _save({"style_emb_func": gst_sd}, model_dir or os.path.join(models_dir(), "Embedding"),
          "embedding_function.pt")
    return gst_sd
