"""Sharded checkpoints of a train state on the mesh.

Counterpart of ``toucan_tpu/train/sharded_checkpointing.py`` (orbax), on
``torch.distributed.checkpoint``, with its conventions (the reference's
``toucantts_train_loop.py:160-221``): one directory per step under
``directory`` (named by the step), the ``keep`` newest kept, resume from
the highest step, and SWA over the newest ones.

A state is one of the port's train states (``train/toucan_train.py::
TrainState``, ``train/vocoder_train.py::VocoderTrainState``,
``train/aligner_train.py::AlignerTrainState``): its modules' parameters
and buffers, its optimizers' per-parameter moments, its schedules and its
step.  A weight that is sharded over 'model' (``dist/tensor_parallel.py``)
and its moments are written as a ``DTensor`` of the mesh, so each rank
writes only its own slice; replicated tensors are written once.  A restore
reads onto the layout of the target state, whatever the mesh that wrote
the checkpoint, in place, and returns the target.  Every rank of the mesh
calls these functions; without a process group they run in one process.
The single-device ``.pt`` checkpoints (``train/checkpointing.py``,
``train/vocoder_train.py::checkpoint_payload``) are a separate format.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

_STEP_RE = re.compile(r"^(\d+)$")
_MOMENTS = ("exp_avg", "exp_avg_sq")


def _parts(state):
    """(modules, optimizers, schedulers) of a train state, by field name."""
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    modules = {k: v for k, v in fields.items() if isinstance(v, nn.Module)}
    optimizers = {k: v for k, v in fields.items() if isinstance(v, torch.optim.Optimizer)}
    schedulers = {k: v for k, v in fields.items() if hasattr(v, "state_dict")
                  and k not in modules and k not in optimizers}
    return modules, optimizers, schedulers


def _distributed(p: torch.Tensor, t: torch.Tensor):
    """``t`` (``p`` itself or one of its moments) as the checkpoint holds
    it: a DTensor of this rank's slice where ``p`` is sharded over 'model'."""
    if getattr(p, "tp_dim", None) is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard

    return DTensor.from_local(t, p.tp_mesh, [Replicate(), Shard(p.tp_dim)],
                              run_check=False)


def _param_names(modules):
    return {id(p): f"{m}.{n}" for m, module in modules.items()
            for n, p in module.named_parameters()}


def _checkpoint_dict(state, params_only: bool = False, with_moments=None) -> dict:
    """The flat dict the checkpoint holds, whose tensors share storage with
    the state's (a load writes into the state).  ``with_moments``: names of
    parameters whose missing optimizer moments are made as zeros first (a
    fresh target restored from a checkpoint of a stepped state)."""
    modules, optimizers, schedulers = _parts(state)
    out = {}
    for m, module in modules.items():
        for n, p in module.named_parameters():
            out[f"{m}.{n}"] = _distributed(p, p.detach())
        if params_only:
            continue
        for n, b in module.named_buffers():
            out[f"{m}.{n}"] = b
    if params_only:
        return out
    names = _param_names(modules)
    for o, opt in optimizers.items():
        for group in opt.param_groups:
            for p in group["params"]:
                name = names[id(p)]
                st = opt.state[p]
                if not st and with_moments is not None and name in with_moments:
                    st.update(step=torch.tensor(0.0),
                              **{k: torch.zeros_like(p) for k in _MOMENTS})
                for k, v in st.items():
                    out[f"{o}.{name}.{k}"] = _distributed(p, v) if k in _MOMENTS else v
    for s, sched in schedulers.items():
        out[s] = sched.state_dict()
    out["step"] = int(state.step)
    return out


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def list_sharded_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(directory)
                  if (m := _STEP_RE.match(name)) and os.path.isdir(os.path.join(directory, name)))


def latest_sharded_step(directory: str) -> Optional[int]:
    steps = list_sharded_steps(directory)
    return steps[-1] if steps else None


def save_sharded_checkpoint(directory: str, state: Any, step: int, keep: int = 5) -> str:
    """Write ``state`` as checkpoint ``step`` (each rank its own shards) and
    delete all but the ``keep`` newest; returns the step's directory."""
    import torch.distributed.checkpoint as dcp

    path = os.path.join(os.path.abspath(directory), str(step))
    if _rank0():
        os.makedirs(path, exist_ok=True)
    _barrier()
    dcp.save(_checkpoint_dict(state), checkpoint_id=path)
    _barrier()
    if _rank0():
        for old in list_sharded_steps(directory)[:-keep]:
            shutil.rmtree(os.path.join(os.path.abspath(directory), str(old)))
    _barrier()
    return path


def _load(directory: str, target_state, step: int, params_only: bool = False):
    import torch.distributed.checkpoint as dcp

    path = os.path.join(os.path.abspath(directory), str(step))
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    names = {k.split(".", 1)[1].rsplit(".", 1)[0] for k in saved
             if k.endswith(f".{_MOMENTS[0]}")}
    sd = _checkpoint_dict(target_state, params_only, with_moments=names)
    dcp.load(sd, checkpoint_id=path)
    return sd


def restore_sharded_checkpoint(directory: str, target_state: Any,
                               step: Optional[int] = None) -> Any:
    """Read checkpoint ``step`` (default: the highest) into
    ``target_state``, on its layout, in place; returns it.  Raises
    FileNotFoundError when there is no checkpoint."""
    if step is None:
        step = latest_sharded_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    sd = _load(directory, target_state, step)
    _, _, schedulers = _parts(target_state)
    for s, sched in schedulers.items():
        sched.load_state_dict(sd[s])
    target_state.step = int(sd["step"])
    return target_state


def swa_average(directory: str, target_state: Any, n: int = 2) -> Any:
    """The mean of the ``n`` newest checkpoints' floating-point parameters,
    with everything else (buffers, moments, schedules, step) from the
    newest, in ``target_state`` (JAX's ``swa_average``; the reference's
    manual SWA, ``run_weight_averaging.py:74-105``)."""
    steps = list_sharded_steps(directory)[-n:]
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    params = []
    for s in steps[:-1]:
        restore_sharded_checkpoint(directory, target_state, s)
        params.append({k: v.to_local().clone() if hasattr(v, "to_local") else v.clone()
                       for k, v in _checkpoint_dict(target_state, params_only=True).items()})
    restore_sharded_checkpoint(directory, target_state, steps[-1])
    if not params:
        return target_state
    newest = _checkpoint_dict(target_state, params_only=True)
    with torch.no_grad():
        for k, v in newest.items():
            local = v.to_local() if hasattr(v, "to_local") else v
            if not local.is_floating_point():
                continue
            out = params[0][k] / len(steps)   # JAX's order: oldest first
            for older in params[1:]:
                out = out + older[k] / len(steps)
            local.copy_(out + local / len(steps))
    return target_state
