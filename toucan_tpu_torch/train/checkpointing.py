"""Checkpointing, resume and manual SWA.

Counterpart of ``toucan_tpu/train/checkpointing.py``, in the reference's
own file layout (``toucantts_train_loop.py:160-221``,
``run_weight_averaging.py``): ``checkpoint_<step>.pt`` holds ``model``
(its state dict, BatchNorm running statistics included), ``optimizer``,
``scheduler``, ``step_counter``, ``default_emb`` and, with a critic,
``discriminator``; the five newest are kept; ``resume`` takes the highest
step.  SWA averages the parameters of the newest N checkpoints (the other
entries come from the newest) into ``best.pt``, which ``load.py`` reads
as a reference checkpoint, and loads the averaged parameters into the live
state.  Everything a file holds is a tensor or a number, so it loads with
``weights_only=True``.
"""

from __future__ import annotations

import os
import re

import torch

_CKPT_RE = re.compile(r"checkpoint_(\d+)\.pt$")


def _payload(state, default_emb=None) -> dict:
    out = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
           "scheduler": state.scheduler.state_dict(), "step_counter": state.step}
    if state.disc is not None:
        out["discriminator"] = state.disc.state_dict()
    if default_emb is not None:
        out["default_emb"] = default_emb.detach().reshape(-1)
    return out


def save_checkpoint(directory: str, state, step: int, keep: int = 5, default_emb=None) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"checkpoint_{step}.pt")
    torch.save(_payload(state, default_emb), path)
    delete_old_checkpoints(directory, keep=keep)
    return path


def list_checkpoints(directory: str):
    """Checkpoint paths, lowest step first."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        m = _CKPT_RE.search(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    return [p for _, p in sorted(found)]


def delete_old_checkpoints(directory: str, keep: int = 5):
    paths = list_checkpoints(directory)
    for path in paths[:-keep] if keep else paths:
        os.remove(path)


def get_most_recent_checkpoint(directory: str):
    paths = list_checkpoints(directory)
    return paths[-1] if paths else None


def _load(path, device):
    return torch.load(path, map_location=device, weights_only=True)


def load_checkpoint(path: str, state, fine_tune: bool = False):
    """Load a checkpoint into ``state`` in place: everything, or with
    ``fine_tune`` the model's weights, statistics and buffers only."""
    device = next(state.model.parameters()).device
    ckpt = _load(path, device)
    state.model.load_state_dict(ckpt["model"])
    if fine_tune:
        return state
    if state.disc is not None:
        state.disc.load_state_dict(ckpt["discriminator"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step_counter"])
    return state


def _param_names(module):
    # a shared module's parameters appear once in named_parameters but under
    # every name in the state dict: average every state-dict name of a parameter
    ids = {id(p) for p in module.parameters()}
    return [k for k, v in module.state_dict(keep_vars=True).items() if id(v) in ids]


def average_checkpoints(paths, state) -> dict:
    """The newest checkpoint's contents with the parameters of ``model``
    (and ``discriminator``) averaged over ``paths`` (reference
    ``run_weight_averaging.py:74-105``)."""
    ckpts = [_load(p, "cpu") for p in paths]
    out = dict(ckpts[-1])
    for key, module in (("model", state.model), ("discriminator", state.disc)):
        if module is None:
            continue
        sd = dict(out[key])
        for name in _param_names(module):
            sd[name] = torch.stack([c[key][name] for c in ckpts]).mean(0)
        out[key] = sd
    return out


def swa_update(directory: str, state, n: int = 2):
    """Average the n newest checkpoints into best.pt and load the averaged
    parameters into the live state (statistics and optimizer stay live)."""
    paths = list_checkpoints(directory)[-n:]
    if len(paths) < n:
        return state
    averaged = average_checkpoints(paths, state)
    torch.save(averaged, os.path.join(directory, "best.pt"))
    with torch.no_grad():
        for key, module in (("model", state.model), ("discriminator", state.disc)):
            if module is None:
                continue
            for name, p in module.named_parameters():
                p.copy_(averaged[key][name])
    return state
