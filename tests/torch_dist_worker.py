"""One rank of the port's multi-rank CPU tests (imports torch and the port
only, never JAX).

    python tests/torch_dist_worker.py JOB RANK WORLD PORT N_DATA N_MODEL IN OUT

joins a gloo group of WORLD ranks on localhost:PORT, makes the
(N_DATA, N_MODEL) mesh, runs JOB on the inputs that the test wrote to IN
(``torch.save`` of a dict) and, on rank 0, writes what the test compares
to OUT.  ``launch`` starts the ranks of one mesh with a clock each.
"""

import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


# ------------------------------------------------------------------ jobs

def _unshard_all(module, optimizer):
    """{name: (param, grad, exp_avg, exp_avg_sq)} whole, on every rank."""
    from toucan_tpu_torch.dist.tensor_parallel import unshard

    out = {}
    for name, p in module.named_parameters():
        st = optimizer.state.get(p, {})
        moments = [unshard(p, st[k]) if k in st else None for k in ("exp_avg", "exp_avg_sq")]
        out[name] = (unshard(p, p), unshard(p, p.grad), *moments)
    return out


def acoustic_step(inp, mesh, naive=False):
    """One ToucanTTS step with the critic on this rank's rows of the global
    batch (``naive``: the DDP trap instead: local losses, local BatchNorm
    moments, each rank padded to its own batch, gradients averaged)."""
    from toucan_tpu_torch.data.batching import pad_batch
    from toucan_tpu_torch.data.prefetch import to_tensors
    from toucan_tpu_torch.dist import make_global_batch, shard_train_state
    from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
    from toucan_tpu_torch.train import toucan_train as tt

    dtype = inp.get("dtype", torch.float32)
    state = tt.create_train_state(ToucanTTSConfig(**inp["config"]), inp["gst"],
                                  use_discriminator=True, device="cpu", **inp["opt"])
    state.model.load_state_dict(inp["tts"])
    state.disc.load_state_dict(inp["disc"])
    state.model.conv_postnet.dropout_rate = 0.0
    for m in (state.model, state.disc, state.gst):
        m.to(dtype)
    n, r = (1, 0) if mesh is None else (mesh.size(0), mesh.get_local_rank("data"))
    b = len(inp["starts"])
    rows = slice(r * b // n, (r + 1) * b // n)
    starts = inp["starts"][rows]
    if naive:
        points = inp["datapoints"][rows]
        batch = to_tensors(pad_batch(points), torch.device("cpu"))
        batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
        tt.compute_gradients(state, batch, True, True, window_starts=starts)
        params = state.parameters()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            torch.distributed.all_reduce(p.grad, group=mesh.get_group("data"))
            p.grad /= n
        tt.clip_by_global_norm([p.grad for p in params], tt.CLIP)
        return {name: p.grad.clone() for name, p in state.model.named_parameters()}
    if mesh is None:  # the single-process step on the global batch
        batch = to_tensors(inp["batch"], torch.device("cpu"))
    else:
        shard_train_state(state, mesh)
        batch = make_global_batch(inp["batch"], mesh, "cpu")
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    metrics = tt.make_train_step(True, True, mesh=mesh)(state, batch, window_starts=starts)
    stats = {k: v.clone() for k, v in state.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return {"tts": _unshard_all(state.model, state.optimizer),
            "disc": _unshard_all(state.disc, state.optimizer),
            "stats": stats, "metrics": {k: v.clone() for k, v in metrics.items()}}


def acoustic(inp, mesh):
    """The step in float64 (against the single-process step) and in float32
    (against JAX), and the DDP trap in float64."""
    f64 = dict(inp, dtype=torch.float64)
    return {"step64": acoustic_step(f64, mesh), "step32": acoustic_step(inp, mesh),
            "naive": acoustic_step(f64, mesh, naive=True) if mesh.size(0) > 1 else None}


def _rows(mesh, b):
    n, r = (1, 0) if mesh is None else (mesh.size(0), mesh.get_local_rank("data"))
    return slice(r * b // n, (r + 1) * b // n)


def _local(batch, mesh, dtype):
    """This rank's rows of a global host batch, floats in ``dtype``."""
    rows = _rows(mesh, len(next(iter(batch.values()))))
    out = {k: torch.from_numpy(v[rows].copy()) for k, v in batch.items()}
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in out.items()}


def _full(module):
    from toucan_tpu_torch.dist.tensor_parallel import full_state_dict

    return {k: v.clone() for k, v in full_state_dict(module).items()}


def vocoder_step(inp, mesh, dtype=torch.float64, adversarial=True):
    """One adversarial HiFiGAN step with the critic update, or the mel-only
    warm-up step (``mesh=None``: the single-process step on the global
    batch)."""
    from toucan_tpu_torch.models.vocoders.discriminators import AvocodoJointDiscriminator
    from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
    from toucan_tpu_torch.train import vocoder_train as vt

    gen = HiFiGANGenerator(**inp["generator"])
    gen.load_state_dict(inp["g"])
    disc = AvocodoJointDiscriminator(**inp["critic"])
    disc.load_state_dict(inp["d"])
    state = vt.create_vocoder_train_state(gen.to(dtype), disc.to(dtype), g_lr=inp["lr"],
                                          d_lr=inp["lr"], device="cpu")
    if mesh is None:
        step = vt.make_vocoder_train_step(use_adversarial=adversarial)
    else:
        warm, adv, state = vt.make_sharded_vocoder_steps(state, mesh)
        step = adv if adversarial else (lambda s, b, _update: warm(s, b))
    metrics = step(state, _local(inp["batch"], mesh, dtype), adversarial)
    return {"g": _full(state.generator), "d": _full(state.discriminator),
            "metrics": {k: v.clone() for k, v in metrics.items()}}


def aligner_step(inp, mesh, dtype=torch.float64):
    """One aligner step, deterministic (``mesh=None``: single-process)."""
    from toucan_tpu_torch.models.aligner import Aligner
    from toucan_tpu_torch.train import aligner_train as at

    asr, tts = Aligner(), at.TinyTTS()
    asr.load_state_dict(inp["asr"])
    tts.load_state_dict(inp["tts"])
    state = at.create_aligner_train_state(lr=inp["lr"], device="cpu", asr=asr.to(dtype),
                                          tts=tts.to(dtype))
    state.step = inp["step"]
    if mesh is None:
        step = at.make_aligner_train_step()
    else:
        step, state = at.make_sharded_aligner_step(state, mesh)
    metrics = step(state, _local(inp["batch"], mesh, dtype), deterministic=True)
    return {"asr": {k: v.clone() for k, v in state.asr.state_dict().items()},
            "tts": {k: v.clone() for k, v in state.tts.state_dict().items()},
            "metrics": {k: v.clone() for k, v in metrics.items()}}


def gan_and_aligner(inp, mesh):
    """Float64 against one process; float32 against JAX (the vocoder's
    warm-up step: JAX's adversarial step takes a minute to compile)."""
    return {"vocoder": {"64": vocoder_step(inp["vocoder"], mesh),
                        "32": vocoder_step(inp["vocoder"], mesh, torch.float32,
                                           adversarial=False)},
            "aligner": {"64": aligner_step(inp["aligner"], mesh),
                        "32": aligner_step(inp["aligner"], mesh, torch.float32)}}


def snapshot(state):
    """Everything a train state holds, whole (sharded tensors gathered)."""
    from toucan_tpu_torch.dist.tensor_parallel import unshard

    out = {"step": state.step, "scheduler": state.scheduler.state_dict()}
    for m in ("model", "disc"):
        module = getattr(state, m)
        for n, p in module.named_parameters():
            out[f"{m}.{n}"] = unshard(p, p).clone()
            for k, v in state.optimizer.state.get(p, {}).items():
                out[f"{m}.{n}.{k}"] = unshard(p, v).clone() if v.dim() else v.clone()
        for n, b in module.named_buffers():
            out[f"{m}.{n}"] = b.clone()
    return out


def checkpoints(inp, _mesh):
    """Two steps on the (1, n) layout, each saved; restored onto (1, n) and
    (n, 1); the SWA of both; keep-5 over seven saves."""
    import torch.distributed as dist

    from toucan_tpu_torch.data.prefetch import to_tensors
    from toucan_tpu_torch.dist import make_mesh, shard_train_state
    from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
    from toucan_tpu_torch.train import sharded_checkpointing as sc
    from toucan_tpu_torch.train import toucan_train as tt

    n = dist.get_world_size()
    layouts = {"1xn": make_mesh(1, n), "nx1": make_mesh(n, 1)}

    def fresh(layout, seed):
        state = tt.create_train_state(ToucanTTSConfig(**inp["config"]), inp["gst"],
                                      use_discriminator=True, device="cpu", seed=seed,
                                      **inp["opt"])
        state.model.conv_postnet.dropout_rate = 0.0
        return shard_train_state(state, layouts[layout])

    directory = inp["ckpt_dir"]
    src = fresh("1xn", 0)
    step = tt.make_train_step(True, True, mesh=layouts["1xn"])
    batch = to_tensors(inp["batch"], torch.device("cpu"))
    saved = []
    for _ in range(2):
        step(src, batch, window_starts=inp["starts"])
        sc.save_sharded_checkpoint(directory, src, src.step)
        saved.append(snapshot(src))
    out = {"saved": saved, "steps": sc.list_sharded_steps(directory),
           "latest": sc.latest_sharded_step(directory)}
    for layout in layouts:
        out[f"restored_{layout}"] = snapshot(sc.restore_sharded_checkpoint(
            directory, fresh(layout, 5)))
    out["restored_first"] = snapshot(sc.restore_sharded_checkpoint(directory, fresh("nx1", 5),
                                                                   step=1))
    out["swa"] = snapshot(sc.swa_average(directory, fresh("1xn", 6), n=2))
    keep_dir = directory + "_keep"
    for s in range(7):
        sc.save_sharded_checkpoint(keep_dir, src, s, keep=5)
    out["kept"] = sc.list_sharded_steps(keep_dir)
    return out


def loops(inp, mesh):
    """``train_loop`` (an epoch, then a resumed one), ``_aligner_train_fn``
    and ``_vocoder_pipeline`` on the mesh."""
    from toucan_tpu_torch.dist.mesh import all_gather
    from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
    from toucan_tpu_torch.models.vocoders.discriminators import AvocodoJointDiscriminator
    from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
    from toucan_tpu_torch.recipes import pipelines
    from toucan_tpu_torch.train import sharded_checkpointing as sc
    from toucan_tpu_torch.train.loop import train_loop

    directory = inp["loop_dir"]
    kw = dict(config=ToucanTTSConfig(**inp["config"]), batch_size=4, postnet_start_steps=1,
              warmup_steps=2, log_every=1, use_discriminator=True, device="cpu", mesh=mesh)
    state, history = train_loop(inp["dataset"], inp["gst"], directory, steps=3, **kw)
    out = {"steps": [state.step], "history": history,
           "saved": sc.list_sharded_steps(directory),
           "dropout_seeds": all_gather(torch.tensor([float(torch.initial_seed())],
                                                    dtype=torch.float64),
                                       torch.distributed.group.WORLD)}
    state, history = train_loop(inp["dataset"], inp["gst"], directory, steps=5, resume=True,
                                **kw)
    out["steps"].append(state.step)
    out["history"] += history
    out["saved_after_resume"] = sc.list_sharded_steps(directory)
    out["aligner_step"] = pipelines._aligner_train_fn(inp["aligner_data"], 2, device="cpu",
                                                      mesh=mesh).step
    os.environ["TOUCAN_CORPORA_ROOT"] = inp["corpora"]
    pipelines.CHECKPOINT_EVERY = 2
    voc_dir = directory + "_vocoder"
    gen = HiFiGANGenerator(channels=32, resblock_kernel_sizes=(3,), resblock_dilations=(1, 3))
    disc = AvocodoJointDiscriminator(channel_scale=0.05,
                                     generator=torch.Generator().manual_seed(0))
    state = pipelines._vocoder_pipeline(
        "Avocodo", gen, steps=4, batch_size=2, generator_warmup=-99, model_dir=voc_dir,
        device="cpu", discriminator=disc, n_data=mesh.size(0), n_model=mesh.size(1))
    out["vocoder"] = (state.step, sc.list_sharded_steps(voc_dir))
    return out


def dropout_loop(inp, mesh):
    """``train_loop`` with dropout on, after the caller seeded every rank
    apart.  Returns, gathered from every rank: each step's largest
    difference over 'model' of the replicated gradients before they are
    made to agree, that of the replicated parameters after the loop, the
    logged losses, and the seeds of the default stream
    and of the column-split convs' stream."""
    from toucan_tpu_torch.dist import tensor_parallel as tp
    from toucan_tpu_torch.dist.mesh import all_gather
    from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
    from toucan_tpu_torch.train.loop import train_loop

    world = torch.distributed.group.WORLD
    torch.manual_seed(1000 + torch.distributed.get_rank())
    apart, agree = [], tp.MeshStep.agree_over_model

    def checked(self, grads):
        parts = all_gather(torch.cat([g.reshape(-1) for g in grads]), self.model_group)
        apart.append(float((parts - parts[0]).abs().max()))
        agree(self, grads)

    tp.MeshStep.agree_over_model = checked
    try:
        state, history = train_loop(
            inp["dataset"], inp["gst"], inp["loop_dir"] + "_dropout", steps=1,
            config=ToucanTTSConfig(**inp["dropout_config"]), batch_size=4,
            postnet_start_steps=0, warmup_steps=2, log_every=1, device="cpu", mesh=mesh)
    finally:
        tp.MeshStep.agree_over_model = agree
    column = next(m for m in state.model.modules()
                  if isinstance(m, tp.ShardedConv1d) and m.kind == "column")
    seeds = torch.tensor([float(torch.initial_seed()), float(column.generator.initial_seed())],
                         dtype=torch.float64)
    replicated = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()
                            if getattr(p, "tp_dim", None) is None])
    parts = all_gather(replicated, world)
    return {"apart": apart, "params_apart": float((parts - parts[0]).abs().max()),
            "losses": all_gather(torch.tensor(
                [h["total_loss"] for h in history], dtype=torch.float64), world),
            "seeds": all_gather(seeds, world)}


def acoustic_and_loops(inp, mesh):
    return {**acoustic(inp, mesh), "loops": loops(inp, mesh)}


def acoustic_and_checkpoints(inp, mesh):
    return {**acoustic(inp, mesh), "checkpoints": checkpoints(inp, mesh),
            "dropout_loop": dropout_loop(inp, mesh)}


def _vocoder(spec):
    from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
    from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator

    cls = {"hifigan": HiFiGANGenerator, "bigvgan": BigVGAN}[spec["kind"]]
    voc = cls(**spec["kwargs"])
    voc.load_state_dict(spec["sd"])
    return voc.eval()


def longform(inp, mesh):
    """The collectives' two routes, then each vocoder's mels time-sharded
    over every rank, then the interface's ``mesh=`` path."""
    import torch.distributed as dist

    from toucan_tpu_torch.dist.longform import synthesize_longform
    from toucan_tpu_torch.dist.mesh import all_gather, ppermute

    group, rank = mesh.get_group("data"), dist.get_rank()
    x = torch.arange(6.0).reshape(2, 3) + 10 * rank
    out = {"gather": [all_gather(x, group, native=v) for v in (False, True)],
           "ppermute": [ppermute(x, group, s, native=v) for s in (1, -1) for v in (False, True)]}
    for name, spec in inp["vocoders"].items():
        voc = _vocoder(spec)
        for key, mel in spec["mels"].items():
            out[f"{name}/{key}"] = synthesize_longform(voc, mel, mesh)
    if "interface" in inp:
        out["interface"] = _interface_wave(inp["interface"], mesh)
    return out


def _interface_wave(spec, mesh):
    from toucan_tpu_torch.infer.interface import ToucanTTSInterface
    from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig

    iface = ToucanTTSInterface(spec["tts"], spec["voc"]["sd"],
                               config=ToucanTTSConfig(**spec["config"]),
                               vocoder=_vocoder(spec["voc"]), device="cpu", use_g2p=False,
                               mesh=mesh, longform_frames=spec["longform_frames"])
    return iface(spec["phones"], input_is_phones=True, durations=spec["durations"],
                 glow_noise=spec["noise"])


JOBS = {"acoustic": acoustic, "acoustic_and_checkpoints": acoustic_and_checkpoints,
        "acoustic_and_loops": acoustic_and_loops, "gan_and_aligner": gan_and_aligner,
        "longform": longform}


def main(argv):
    job, rank, world, port, n_data, n_model, inp_path, out_path = argv
    torch.set_num_threads(1)
    from toucan_tpu_torch.dist import initialize_distributed, make_mesh

    initialize_distributed(f"localhost:{port}", int(world), int(rank), backend="gloo",
                           timeout_s=90)
    try:
        mesh = make_mesh(int(n_data), int(n_model))
        out = JOBS[job](torch.load(inp_path, weights_only=False), mesh)
        if int(rank) == 0:
            torch.save(out, out_path)
    finally:
        torch.distributed.destroy_process_group()


# --------------------------------------------------------------- launcher

def start(job, n_data, n_model, inp_path, out_path):
    """Start the ranks of one mesh; returns their processes."""
    from toucan_tpu_torch.dist.launch import free_port

    world, port = n_data * n_model, free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r),
                              str(world), str(port), str(n_data), str(n_model),
                              inp_path, out_path],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for r in range(world)]


def wait(procs, timeout_s=120.0):
    """Wait for every rank, each within the same deadline; kill them all
    and raise with their output if one fails or the deadline passes."""
    deadline = time.monotonic() + timeout_s
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"ranks did not finish within {timeout_s:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, log) for i, (p, log) in enumerate(zip(procs, logs)) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"rank {bad[0][0]} failed:\n{bad[0][1][-4000:]}")


if __name__ == "__main__":
    main(sys.argv[1:])
