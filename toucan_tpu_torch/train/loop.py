"""ToucanTTS training loops (mono and meta) and the loop arbiter.

Counterpart of ``toucan_tpu/train/loop.py``; reference loops ``toucantts_train_loop.py``,
``toucantts_meta_train_loop.py`` and ``toucantts_train_loop_arbiter.py``:
lr 1e-3, warm-up 8k, batch 24, the glow joins after ``postnet_start_steps``;
a checkpoint per epoch (mono) or per ``steps_per_checkpoint`` steps (meta,
1000 by default), keep-5, and past 3 x ``postnet_start_steps`` SWA over the
newest two into ``best.pt``, reloaded live; ``resume`` continues from the
highest checkpoint, ``fine_tune`` loads only the model's weights.

With a ``mesh`` (``dist.make_mesh``) every rank of it calls ``train_loop``:
each data rank samples its 1/n of the global batch with its own seed
(``seed + 7919 * data rank``, the ranks of one 'model' group alike) padded
to the dataset-wide shapes, draws its dropout masks as
``dist/tensor_parallel.py::seed_dropout`` seeds them, the step is
``make_train_step(mesh=...)`` on a state put on the mesh, and checkpoints, keep-5, resume and SWA go through
``train/sharded_checkpointing.py`` (one directory per step).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from toucan_tpu_torch.data.batching import BatchSampler, MetaBatchSampler
from toucan_tpu_torch.data.prefetch import DevicePrefetcher
from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
from toucan_tpu_torch.train import checkpointing
from toucan_tpu_torch.train.toucan_train import create_train_state, make_train_step
from toucan_tpu_torch.utils.device import f32_precision, resolve_device


def train_loop(datasets, gst_state_dict, save_directory: str,
               config: Optional[ToucanTTSConfig] = None, batch_size: int = 24,
               lr: float = 1e-3, warmup_steps: int = 8000, steps: int = 80_000,
               postnet_start_steps: int = 9000, use_discriminator: bool = False,
               resume: bool = False, path_to_checkpoint: Optional[str] = None,
               fine_tune: bool = False, seed: int = 131714,
               steps_per_checkpoint: Optional[int] = None, log_every: int = 50,
               callbacks=(), prefetch: int = 2, device=None, mesh=None):
    """Train until past ``steps``; returns (state, history of logged metrics).

    ``datasets``: one dataset (a sequence of datapoint dicts, as
    ``data/batching.py::pad_batch`` takes them) for the mono loop, or a list
    of them, one per language, for the meta loop.  ``gst_state_dict``: the
    frozen StyleEmbedding's weights.  ``device=None`` is the card.
    ``callbacks`` are called as ``cb(step, metrics)`` every ``log_every``
    steps.  The steps run under the port's "float32" precision policy (no
    TF32 in cuDNN and cuBLAS), as every entry point of the port does.
    """
    config = config or ToucanTTSConfig()
    device = resolve_device(device)
    if not isinstance(datasets, (list, tuple)) or (
            len(datasets) > 0 and isinstance(datasets[0], dict)):
        datasets = [datasets]
    is_meta = len(datasets) > 1
    state = create_train_state(config, gst_state_dict, lr=lr, warmup_steps=warmup_steps,
                               max_steps=steps, use_discriminator=use_discriminator,
                               device=device, seed=seed)
    if resume and mesh is None:
        path_to_checkpoint = checkpointing.get_most_recent_checkpoint(save_directory)
    if path_to_checkpoint is not None:  # a single-device .pt, read before any sharding
        checkpointing.load_checkpoint(path_to_checkpoint, state, fine_tune=fine_tune)
    local_bs, pad_to, rank0 = batch_size, None, True
    if mesh is not None:
        from toucan_tpu_torch.data.batching import _ceil_to
        from toucan_tpu_torch.dist.mesh import shard_train_state
        from toucan_tpu_torch.dist.tensor_parallel import seed_dropout
        from toucan_tpu_torch.train import sharded_checkpointing as sharded

        n_data, data_rank = mesh.size(0), mesh.get_local_rank("data")
        assert batch_size % n_data == 0, \
            f"global batch {batch_size} must divide over {n_data} data ranks"
        shard_train_state(state, mesh)
        seed_dropout(state.model, mesh, seed)
        local_bs, seed = batch_size // n_data, seed + 7919 * data_rank
        pad_to = (_ceil_to(max(len(d["text"]) for ds in datasets for d in ds), 32),
                  _ceil_to(max(len(d["mel"]) for ds in datasets for d in ds), 64))
        rank0 = torch.distributed.get_rank() == 0
        if resume and sharded.latest_sharded_step(save_directory) is not None:
            sharded.restore_sharded_checkpoint(save_directory, state)

    first = datasets[0][0]  # the reference's default embedding: its first utterance's
    mel = torch.from_numpy(np.asarray(first["mel"], np.float32))[None].to(device)
    with f32_precision():
        default_emb = state.gst(mel, [mel.shape[1]])[0]

    if is_meta:
        sampler = MetaBatchSampler(datasets, local_bs, seed=seed, pad_to=pad_to)
        steps_per_ckpt = steps_per_checkpoint or 1000
    else:
        sampler = BatchSampler(datasets[0], local_bs, seed=seed, pad_to=pad_to)
    generator = torch.Generator(device=device).manual_seed(seed + 1)  # the critic's windows
    step_fns = {glow: make_train_step(glow, use_discriminator, mesh=mesh)
                for glow in (False, True)}
    start = time.time()
    history = []
    while True:
        epoch = (sampler.sample_batch() for _ in range(steps_per_ckpt)) if is_meta \
            else iter(sampler)
        # sampling, padding and the copy of batch N+1 overlap step N
        batches = DevicePrefetcher(epoch, device, depth=prefetch)
        try:
            with f32_precision():
                for batch in batches:
                    step_count = state.step
                    run_glow = step_count > postnet_start_steps or fine_tune
                    metrics = step_fns[run_glow](state, batch, generator=generator)
                    if step_count % log_every == 0:
                        history.append({k: float(v) for k, v in metrics.items()})
                        for cb in callbacks:
                            cb(step_count, history[-1])
        finally:
            batches.close()
        if mesh is not None:
            sharded.save_sharded_checkpoint(save_directory, state, state.step)
            if state.step > 3 * postnet_start_steps:
                sharded.swa_average(save_directory, state, n=2)
        else:
            checkpointing.save_checkpoint(save_directory, state, state.step,
                                          default_emb=default_emb)
            if state.step > 3 * postnet_start_steps:
                checkpointing.swa_update(save_directory, state, n=2)
        if rank0:
            print(f"steps: {state.step}  elapsed: {round((time.time() - start) / 60)} min")
        if state.step > steps:
            return state, history
