"""Train-step throughput of ToucanTTS over a ('data', 'model') mesh.

Counterpart of ``toucan_tpu/dist/scaling_bench.py``: ``measure`` times the
acoustic train step (the glow on, no critic) on a synthetic batch of
``batch_per_device`` utterances per data rank, 64 phones and 384 frames
each, and reports utterances/s and mel frames/s, in all and per device.
On the card a step is timed by CUDA events, and the card's name and power
limit (``nvidia-smi --query-gpu=name,power.limit``) stand beside the rates.

    python -m toucan_tpu_torch.dist.scaling_bench [--n_data N] [--n_model M] \
        [--batch_per_device 8] [--sweep]
    python -m toucan_tpu_torch.dist.scaling_bench --virtual 2

The first runs the mesh ``--n_data`` x ``--n_model`` (``--n_data``
defaults to every visible card), one NCCL rank per card, or one process
when the mesh is 1 x 1; ``--sweep`` runs one card alone, then every card,
and reports the scaling efficiency.  ``--virtual N``
starts N gloo ranks on the CPU with a small configuration and short
sequences (16 phones, 64 frames, 2 utterances per rank) and checks
correctness, not speed: the first step's losses on the mesh against the
same step in one process on the global batch.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

# the small configuration of ``--virtual`` (the tests' tiny ToucanTTS),
# without dropout, whose draws differ between the ranks and one process
VIRTUAL_CONFIG = dict(adim=32, aheads=2, enc_layers=1, enc_units=64, dec_layers=1,
                      dec_units=64, duration_layers=1, pitch_layers=1, energy_layers=1,
                      duration_chans=16, pitch_chans=16, energy_chans=16, glow_blocks=2,
                      glow_hidden=16, utt_embed_dim=64, lang_embs=100, dropout=0.0,
                      duration_dropout=0.0, pitch_dropout=0.0, energy_dropout=0.0)


def card_name() -> str:
    """``nvidia-smi``'s "name, power limit" of the first card, or "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else torch.cuda.get_device_name(0)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def synthetic_batch(batch_size: int, tmax: int, lmax: int, seed: int = 0) -> dict:
    """JAX's synthetic batch: every utterance ``tmax`` phones of
    ``lmax // tmax`` frames each."""
    rnd = np.random.RandomState(seed)
    return dict(text=(rnd.rand(batch_size, tmax, 62) > 0.5).astype(np.float32),
                text_lengths=np.full((batch_size,), tmax, np.int32),
                gold_speech=rnd.randn(batch_size, lmax, 80).astype(np.float32),
                speech_lengths=np.full((batch_size,), lmax, np.int32),
                gold_durations=np.full((batch_size, tmax), lmax // tmax, np.int32),
                gold_pitch=rnd.rand(batch_size, tmax, 1).astype(np.float32),
                gold_energy=rnd.rand(batch_size, tmax, 1).astype(np.float32),
                lang_ids=rnd.randint(0, 100, size=(batch_size, 1)))


def _state(config, device):
    from toucan_tpu_torch.models.gst import StyleEmbedding
    from toucan_tpu_torch.train.toucan_train import create_train_state

    torch.manual_seed(0)
    return create_train_state(config, StyleEmbedding().state_dict(), device=device, seed=0)


def measure(n_data=None, n_model=1, batch_per_device=8, tmax=64, lmax=384, steps=10,
            config=None, device=None, mesh=None):
    """Time ``steps`` train steps after one warm-up step; returns the rates.
    ``mesh``: this rank's mesh when the caller is one rank of several
    (``n_data``/``n_model`` are then the mesh's); without one this process
    is the only device, and a mesh of more raises ValueError (``on_cards``
    starts its ranks)."""
    from toucan_tpu_torch.dist.mesh import make_global_batch, shard_train_state
    from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
    from toucan_tpu_torch.train.toucan_train import make_train_step
    from toucan_tpu_torch.utils.device import f32_precision, resolve_device

    device = resolve_device(device)
    if mesh is not None:
        n_data, n_model = mesh.size(0), mesh.size(1)
    n_data = n_data or 1
    if mesh is None and n_data * n_model > 1:
        raise ValueError(f"a {n_data}x{n_model} mesh needs one rank per device: pass this "
                         "rank's mesh, or start the ranks with on_cards")
    batch_size = batch_per_device * n_data
    config = config or ToucanTTSConfig()
    state = _state(config, device)
    if config.dropout == 0.0:  # the PostNet drops at 0.5 whatever the config says
        state.model.conv_postnet.dropout_rate = 0.0
    batch = synthetic_batch(batch_size, tmax, lmax)
    if mesh is not None:
        from toucan_tpu_torch.dist.tensor_parallel import seed_dropout

        shard_train_state(state, mesh)
        seed_dropout(state.model, mesh, 0)
        batch = make_global_batch(batch, mesh, device)
    else:
        from toucan_tpu_torch.data.prefetch import to_tensors
        batch = to_tensors(batch, device)
    step = make_train_step(run_glow=True, mesh=mesh)
    cuda = device.type == "cuda"
    with f32_precision():
        first = {k: float(v) for k, v in step(state, batch).items()}  # warm-up
        if cuda:
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch)
        if cuda:
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / max(steps, 1)
        else:
            dt = (time.perf_counter() - t0) / max(steps, 1)
    n_devices = n_data * n_model
    return {"devices": n_devices, "mesh": f"{n_data}x{n_model}", "batch_size": batch_size,
            "step_seconds": dt, "utterances_per_second": batch_size / dt,
            "mel_frames_per_second": batch_size * lmax / dt,
            "per_device_utterances_per_second": batch_size / dt / n_devices,
            "per_device_mel_frames_per_second": batch_size * lmax / dt / n_devices,
            "card": card_name(), "first_step": first}


def _virtual_rank(rank, world, n_model):
    """One gloo CPU rank of ``--virtual``."""
    from toucan_tpu_torch.dist.mesh import make_mesh
    from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig

    torch.set_num_threads(1)
    mesh = make_mesh(n_model=n_model)
    return measure(batch_per_device=2, tmax=16, lmax=64, steps=2,
                   config=ToucanTTSConfig(**VIRTUAL_CONFIG), device="cpu", mesh=mesh)


def _card_rank(rank, world, n_model, batch_per_device):
    """One NCCL rank of ``--sweep``, on card ``rank``."""
    from toucan_tpu_torch.dist.mesh import make_mesh

    torch.cuda.set_device(rank)
    return measure(batch_per_device=batch_per_device, device=f"cuda:{rank}",
                   mesh=make_mesh(n_model=n_model, device_type="cuda"))


def on_cards(n_data=None, n_model: int = 1, batch_per_device: int = 8) -> dict:
    """The mesh ``n_data`` x ``n_model`` with one NCCL rank per card
    (``n_data`` defaults to every visible card); one process when the mesh
    is 1 x 1.  Raises ValueError when there are fewer cards than ranks."""
    from toucan_tpu_torch.dist.launch import run_ranks

    cards = torch.cuda.device_count()
    n_data = n_data or max(cards // n_model, 1)
    world = n_data * n_model
    if world == 1:
        return measure(batch_per_device=batch_per_device)
    if world > cards:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {world} cards; {cards} visible")
    return run_ranks(_card_rank, world, args=(n_model, batch_per_device), backend="nccl",
                     timeout_s=1800)[0]


def sweep(n_model: int = 1, batch_per_device: int = 8) -> dict:
    """One card alone, then every card as one rank each (NCCL); the
    scaling efficiency is the ratio of the per-device rates."""
    single = measure(batch_per_device=batch_per_device, device="cuda:0")
    if torch.cuda.device_count() == 1:
        return {"single_device": single, "all_devices": single, "scaling_efficiency": 1.0}
    full = on_cards(None, n_model, batch_per_device)
    return {"single_device": single, "all_devices": full,
            "scaling_efficiency": full["per_device_utterances_per_second"]
            / single["per_device_utterances_per_second"]}


def virtual(n: int, n_model: int = 1) -> dict:
    """``n`` gloo CPU ranks: their rates, and the mesh's first-step losses
    against one process's on the global batch (rtol 1e-5)."""
    from toucan_tpu_torch.dist.launch import run_ranks
    from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig

    results = run_ranks(_virtual_rank, n, args=(n_model,), timeout_s=600)
    single = measure(batch_per_device=2 * (n // n_model), tmax=16, lmax=64, steps=0,
                     config=ToucanTTSConfig(**VIRTUAL_CONFIG), device="cpu")
    for k, want in single["first_step"].items():
        got = results[0]["first_step"][k]
        if not np.isclose(got, want, rtol=1e-5, atol=0):
            raise AssertionError(f"{k}: mesh {got} against one process {want}")
    return {**results[0], "checked_against_one_process": sorted(single["first_step"])}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_model", type=int, default=1)
    parser.add_argument("--n_data", type=int, default=None)
    parser.add_argument("--batch_per_device", type=int, default=8)
    parser.add_argument("--virtual", type=int, default=0,
                        help="N gloo CPU ranks (a correctness check, not a speed)")
    parser.add_argument("--sweep", action="store_true",
                        help="one device and every device; report the efficiency")
    args = parser.parse_args(argv)
    if args.virtual:
        out = virtual(args.virtual, args.n_model)
    elif args.sweep:
        out = sweep(args.n_model, args.batch_per_device)
    else:
        out = on_cards(args.n_data, args.n_model, args.batch_per_device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
