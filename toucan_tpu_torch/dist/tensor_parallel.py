"""What a train step needs to run on one rank of the mesh and still be the
single-device step on the global batch.

JAX's sharded steps are its single-device step under ``pjit``: XLA sums
over the global batch wherever the loss does.  The port computes each
rank's share with the global normalisers and sums over 'data':

* ``MeshStep.share``: a rank's weight, b_rank / B, for every loss that is a
  mean over the batch (a rank's local mean times its share, summed over
  'data', is the global mean); sums over utterances need none; a DDP mean
  of local losses would scale those by 1/n instead;
* ``MeshStep.batch_statistics``: BatchNorm in training mode normalises by
  the global batch's moments, the same sums all-reduced over 'data'
  (``nn/convolution.py::train_batch_norm``), with the gradient flowing back
  through the all-reduce (``_AllReduce``);
* ``MeshStep.reduce_gradients``: gradients summed over 'data';
  ``MeshStep.agree_over_model``: the replicated ones taken from the first
  rank of each 'model' group, so the replicas stay equal bit for bit;
* ``MeshStep.clip``: optax's global-norm clip on the global norm, the
  squares of 'model'-sharded gradients summed over 'model' and each
  replicated tensor counted once;
* ``ShardedConv1d``: a conv whose weight is this rank's slice on 'model',
  with Megatron's pair of operators around it: ``copy_to_model`` (identity
  forward, all-reduce backward) in front, and ``reduce_from_model``
  (all-reduce forward, identity backward) or ``gather_from_model``
  (all-gather forward, slice backward) after;
* ``seed_dropout``: dropout's streams, as Megatron's RNG tracker keeps
  them.  JAX's pjit step draws one mask over the global batch; a rank
  draws its own rows' masks, so each data rank needs a stream of its own,
  the replicas of a 'model' group one stream between them (their
  replicated activations must stay equal), and the hidden channels that a
  column-split conv leaves on each 'model' rank a stream per rank.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from toucan_tpu_torch.dist.mesh import all_gather, sharding_rule, sum_over
from toucan_tpu_torch.nn import convolution


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllReduce(torch.autograd.Function):
    """Sum over a group whose ranks each hold a part of one loss: the
    gradient of every rank's input is the sum of the ranks' gradients
    (``torch.distributed.nn.functional.all_reduce``'s rule; that module is
    deprecated from torch 2.13)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """Concatenate every rank's slice along ``dim``; the gradient of the
    replicated result is the same on every rank, so each keeps its slice."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        parts = all_gather(x.movedim(dim, 0), group)           # (n, size, ...)
        return parts.flatten(0, 1).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x, group, dim):
    return _GatherFromModel.apply(x, group, dim)


class ShardedConv1d(nn.Module):
    """A Conv1d whose weight (out, in, k) holds this rank's slice on 'model'.

    ``kind`` (``mesh._TP_RULES``): "column" (weight split on out, output
    left split; the bias, replicated, contributes its slice), "row" (split
    on in, input split, partial outputs summed, then the bias) or
    "gathered" (split on out, output gathered, then the bias).  The
    parameters keep the Conv1d's names, so state-dict keys do not change.
    """

    def __init__(self, conv: nn.Conv1d, kind: str, group, rank: int, n: int):
        super().__init__()
        dim = 1 if kind == "row" else 0
        self.kind, self.group, self.rank = kind, group, rank
        self.padding, self.dilation = conv.padding, conv.dilation
        full = conv.weight.detach()
        size = full.shape[dim] // n
        assert size * n == full.shape[dim], f"{full.shape[dim]} channels over {n} ranks"
        self.weight = nn.Parameter(full.narrow(dim, rank * size, size).clone())
        self.weight.tp_dim, self.weight.tp_rank, self.weight.tp_group = dim, rank, group
        self.bias = conv.bias  # replicated: the same tensor, so optimizers keep it
        self.kernel_size = conv.kernel_size
        self.generator = None  # dropout's stream on a column conv's output (seed_dropout)

    def _conv(self, x):
        return F.conv1d(x, self.weight, None, 1, self.padding, self.dilation)

    def _finish(self, y, channel_dim):
        if self.kind == "row":
            y = reduce_from_model(y, self.group)
        elif self.kind == "gathered":
            y = gather_from_model(y, self.group, channel_dim)
        if self.bias is None:
            return y
        bias = self.bias
        if self.kind == "column":
            size = y.shape[channel_dim]
            bias = copy_to_model(bias, self.group).narrow(0, self.rank * size, size)
        return y + (bias if channel_dim == y.dim() - 1 else bias[:, None])

    def forward(self, x):
        """(B, C, T) -> (B, C', T)."""
        if self.kind != "row":
            x = copy_to_model(x, self.group)
        return self._finish(self._conv(x), 1)

    def forward_btc(self, x):
        """(B, T, C) -> (B, T, C') (``nn/convolution.py::conv_btc``)."""
        if self.kind != "row":
            x = copy_to_model(x, self.group)
        if self.kernel_size[0] == 1:
            return self._finish(F.linear(x, self.weight[..., 0]), x.dim() - 1)
        return self._finish(self._conv(x.transpose(1, 2)), 1).transpose(1, 2)


def shard_module(module: nn.Module, mesh, n_stacks: int = 3) -> dict:
    """Replace, in place, every Conv1d whose weight a rule shards by a
    ``ShardedConv1d`` holding this rank's slice; returns {old parameter:
    new parameter} (the bias keeps its tensor)."""
    group, rank, n = mesh.get_group("model"), mesh.get_local_rank("model"), mesh.size(1)
    swapped = {}
    if n == 1:
        return swapped
    for name, conv in list(module.named_modules()):
        rule = sharding_rule(f"{name}.weight", n_stacks)
        if rule is None or not isinstance(conv, nn.Conv1d):
            continue
        parent_name, _, attr = name.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        sharded = ShardedConv1d(conv, rule[1], group, rank, n)
        sharded.weight.tp_mesh = mesh  # the layout a sharded checkpoint writes
        setattr(parent, attr, sharded)
        swapped[conv.weight] = sharded.weight
    return swapped


def seed_dropout(module: nn.Module, mesh, seed: int):
    """Seed this rank's dropout: the default generators (the host's and the
    cards') from ``seed + 7919 * data rank``, alike over a 'model' group;
    the output of ``module``'s column-split convs (the feed-forwards'
    hidden channels, ``nn/convolution.py::ConvFeedForward``) from one
    stream per 'model' rank besides.  Overrides whatever the caller
    seeded: a seed per rank would part the replicas."""
    base = seed + 7919 * mesh.get_local_rank("data")
    torch.manual_seed(base)
    generator = None
    for m in module.modules():
        if isinstance(m, ShardedConv1d) and m.kind == "column":
            if generator is None:
                generator = torch.Generator(device=m.weight.device).manual_seed(
                    base + (mesh.get_local_rank("model") + 1) * 2 ** 32)
            m.generator = generator


def shard_optimizer(optimizer: torch.optim.Optimizer, swapped: dict):
    """Point ``optimizer`` at the sharded parameters; each moment that has
    its parameter's shape takes the same slice (the moments live with
    their shard, as JAX's ``_opt_sharding`` places them)."""
    for group in optimizer.param_groups:
        for i, p in enumerate(group["params"]):
            new = swapped.get(p)
            if new is None:
                continue
            group["params"][i] = new
            state = optimizer.state.pop(p, None)
            if state:
                optimizer.state[new] = {k: shard_like(v, new) if torch.is_tensor(v)
                                        and v.shape == p.shape else v
                                        for k, v in state.items()}


def shard_like(full: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
    """The slice of ``full`` that the sharded parameter ``shard`` holds."""
    dim, size = shard.tp_dim, shard.shape[shard.tp_dim]
    return full.narrow(dim, shard.tp_rank * size, size).clone()


def _in_one_buffer(tensors, collective):
    """Run an in-place ``collective`` on the tensors copied into one flat
    buffer (one call instead of one a tensor), then copy them back."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class MeshStep:
    """This rank's view of the mesh for a train step."""

    def __init__(self, mesh):
        self.data_group, self.model_group = mesh.get_group("data"), mesh.get_group("model")
        self.n_data, self.n_model = mesh.size(0), mesh.size(1)

    def share(self, b_local: int, device) -> float:
        """b_local / B: this rank's weight for a loss that is a batch mean
        (B, the global batch, is the local sizes summed over 'data')."""
        return b_local / int(sum_over(torch.tensor(float(b_local), device=device),
                                      self.data_group))

    def sum_data(self, x: torch.Tensor) -> torch.Tensor:
        return sum_over(x, self.data_group)

    @contextlib.contextmanager
    def batch_statistics(self):
        """BatchNorm in training mode takes the global batch's moments."""
        with convolution.batch_statistics_reduced_by(
                lambda x: _AllReduce.apply(x, self.data_group)):
            yield

    def reduce_gradients(self, grads):
        """Sum each gradient over 'data', in place."""
        _in_one_buffer(grads, lambda flat: dist.all_reduce(flat, group=self.data_group))

    def clip(self, params, max_norm: float):
        """optax's clip on the global norm of the parameters' ``.grad``."""
        grads = [p.grad for p in params]
        sharded = [p.grad for p in params if getattr(p, "tp_dim", None) is not None]
        replicated = [p.grad for p in params if getattr(p, "tp_dim", None) is None]
        sq = torch.stack(torch._foreach_norm(replicated)).square().sum() if replicated \
            else grads[0].new_zeros(())
        if sharded:
            sq_sh = torch.stack(torch._foreach_norm(sharded)).square().sum()
            sq = sq + sum_over(sq_sh, self.model_group)
        norm = sq.sqrt()
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)

    def agree_over_model(self, grads):
        """Give every rank of a 'model' group the first one's gradients of
        the replicated parameters: they are equal in exact arithmetic, but
        a card's atomics (an embedding's or a conv's backward) round them
        apart, and the replicas would drift from step to step."""
        if self.n_model > 1:
            src = dist.get_global_rank(self.model_group, 0)
            _in_one_buffer(grads, lambda flat: dist.broadcast(flat, src, self.model_group))

    def finish(self, params, max_norm: float):
        """Zero-fill missing gradients, sum over 'data', make the replicated
        ones agree over 'model', clip."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.reduce_gradients([p.grad for p in params])
        self.agree_over_model([p.grad for p in params if getattr(p, "tp_dim", None) is None])
        self.clip(params, max_norm)


def unshard(param: torch.Tensor, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` (the parameter itself, its gradient or a moment) whole:
    gathered over 'model' where ``param`` is sharded (a collective: every
    rank of the 'model' group calls it), else as it is."""
    if getattr(param, "tp_dim", None) is None:
        return tensor.detach()
    parts = all_gather(tensor.detach().contiguous(), param.tp_group)
    return torch.cat(list(parts), dim=param.tp_dim)


def full_state_dict(module: nn.Module) -> dict:
    """``module.state_dict()`` with every 'model'-sharded weight gathered
    back whole (a collective, as ``unshard``)."""
    sd = module.state_dict()
    for name, p in module.named_parameters():
        sd[name] = unshard(p, p)
    return sd
