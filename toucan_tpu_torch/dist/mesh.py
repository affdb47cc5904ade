"""Process groups, the ('data', 'model') mesh, its collectives and the
tensor-parallel rules.

Counterpart of ``toucan_tpu/dist/mesh.py``.  JAX drives its mesh from one
controller and lets XLA insert the collectives; PyTorch's idiom is one
process per device (a rank), SPMD under ``torch.distributed``: every rank
calls the same functions on its share of the batch, and the collectives
are explicit.  The mesh is a ``DeviceMesh`` with dims ``("data", "model")``;
utterance batches split over 'data', and the widest weights (the conformer
feed-forward convs, the vocoder's early residual convs) over 'model',
Megatron style (``dist/tensor_parallel.py``).

Backends: ``nccl`` for ranks on cards of their own, ``gloo`` for the CPU
and for ranks that share one card (NCCL refuses two ranks on one device).
gloo takes only ``all_reduce``, ``broadcast`` and ``barrier`` on CUDA
tensors, so the port's gathers (``all_gather``, the ring ``ppermute``) are
written as an ``all_reduce`` (sum) over a zeroed buffer with one slot per
rank, which is exact (x + 0 = x); with NCCL, or on CPU tensors, the native
``all_gather_into_tensor`` may run instead (``native=True``), and the tests
hold both routes against each other.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")


def resolve_environment(coordinator_address: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None):
    """(address, world size, rank), each from the argument, else
    ``TOUCAN_COORDINATOR`` / ``TOUCAN_NUM_PROCESSES`` / ``TOUCAN_PROCESS_ID``
    (JAX's order), else torchrun's ``MASTER_ADDR:MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``; a field found nowhere raises ValueError."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("TOUCAN_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = env.get("TOUCAN_NUM_PROCESSES", env.get("WORLD_SIZE"))
    if process_id is None:
        process_id = env.get("TOUCAN_PROCESS_ID", env.get("RANK"))
    missing = [name for name, v in (("coordinator_address", coordinator_address),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"distributed set-up needs {', '.join(missing)}: pass them or set "
                         "TOUCAN_COORDINATOR/TOUCAN_NUM_PROCESSES/TOUCAN_PROCESS_ID "
                         "(or torchrun's MASTER_ADDR/WORLD_SIZE/RANK)")
    return coordinator_address, int(num_processes), int(process_id)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, backend: str,
                           timeout_s: float = 120.0) -> str:
    """Join the process group; returns (and prints) the backend.

    ``backend`` is explicit, never switched quietly: "nccl" for ranks on
    cards of their own, "gloo" for the CPU and for ranks sharing a card.
    ``coordinator_address`` is "host:port" of rank 0.  ``timeout_s`` bounds
    every collective, so a rank whose peer died fails instead of hanging.
    """
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    address, world, rank = resolve_environment(coordinator_address, num_processes, process_id)
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    print(f"[dist] rank {rank} of {world}: backend {backend}", flush=True)
    return backend


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device_type: str = "cpu",
              world_size: Optional[int] = None):
    """The ``DeviceMesh`` of every rank, shaped (n_data, n_model), dims
    ("data", "model"); rank r sits at (r // n_model, r % n_model).
    ``device_type`` is the ranks' device type ("cuda" or "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size if world_size is not None else dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, \
        f"{n_data}x{n_model} mesh cannot use {world} devices"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES)


def make_global_batch(batch: dict, mesh, device, local: bool = False) -> dict:
    """Host batch -> this rank's rows as tensors on ``device``.

    ``local=False``: ``batch`` is the global batch, the same on every rank
    (JAX's single-process case), and each rank keeps its data rank's even
    share of the rows.  ``local=True``: ``batch`` is this process's own
    sample of the global batch (JAX's multi-process case), taken whole."""
    from toucan_tpu_torch.data.prefetch import to_tensors

    return to_tensors(batch if local else local_rows(batch, mesh), torch.device(device))


def local_rows(batch: dict, mesh) -> dict:
    """This data rank's even share of the rows of a global host batch."""
    n, r = mesh.size(0), mesh.get_local_rank("data")
    b = len(next(iter(batch.values())))
    assert b % n == 0, f"global batch {b} must divide over {n} data ranks"
    return {k: v[r * b // n:(r + 1) * b // n] for k, v in batch.items()}


# ------------------------------------------------------------------ rules

# (regex over the port's state-dict key, the dim split over 'model', kind).
# JAX's flax kernels are (k, in, out) and its rules split out or in; the
# port's convs are (out, in, k), so out is dim 0 and in dim 1.  Biases stay
# replicated, as JAX's rules match only ``kernel$``.  Kinds:
# "column" keeps its output split (the FFN's w_1, read by the row-split
# w_2), "row" sums its partial output over 'model' (w_2), "gathered" splits
# its output channels and gathers them before the next layer (the
# vocoder's residual convs).
_TP_RULES = [
    (r"feed_forward(_macaron)?\.w_1\.weight$", 0, "column"),
    (r"feed_forward(_macaron)?\.w_2\.weight$", 1, "row"),
    # JAX's block_{stage}_{stack}; the port numbers blocks stage * stacks + stack
    (r"^blocks\.(\d+)\.convs[12]\.\d+\.1\.weight$", 0, "gathered"),
]


def sharding_rule(key: str, n_stacks: int = 3):
    """(dim, kind) of a state-dict key that shards over 'model', or None."""
    for pattern, dim, kind in _TP_RULES:
        m = re.search(pattern, key)
        if m and (kind != "gathered" or int(m.group(1)) // n_stacks in (0, 1)):
            return dim, kind
    return None


def param_sharding_rules(keys, n_stacks: int = 3) -> dict:
    """{key: dim} of the keys that shard over 'model'; every other key is
    replicated.  ``n_stacks``: the vocoder's residual stacks per stage."""
    return {k: rule[0] for k in keys if (rule := sharding_rule(k, n_stacks)) is not None}


# ------------------------------------------------------------ collectives

def group_rank_size(group):
    return dist.get_rank(group), dist.get_world_size(group)


def all_gather(x: torch.Tensor, group, native: Optional[bool] = None) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in rank order.  The default route
    is an all-reduce over a zeroed slot buffer (every backend and device);
    ``native`` (default: on NCCL) uses ``all_gather_into_tensor``."""
    rank, n = group_rank_size(group)
    if native is None:
        native = dist.get_backend(group) == "nccl"
    x = x.contiguous()
    if native:
        out = x.new_empty(n * x.numel())
        dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
        return out.view((n,) + tuple(x.shape))
    out = x.new_zeros((n,) + tuple(x.shape))
    out[rank] = x
    dist.all_reduce(out, group=group)
    return out


def ppermute(x: torch.Tensor, group, shift: int, native: Optional[bool] = None) -> torch.Tensor:
    """JAX's ``ppermute`` with pairs (i, i + shift mod n): each rank sends
    ``x`` to its ``shift``-th ring neighbour and returns what it received."""
    rank, n = group_rank_size(group)
    return all_gather(x, group, native)[(rank - shift) % n]


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``x`` summed over ``group`` (no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


# ------------------------------------------------------------ train states

def shard_train_state(state, mesh):
    """Put a ``train.toucan_train.TrainState`` on the mesh, in place: the
    conformer feed-forward convs keep this rank's slice on 'model' (w_1
    split on out, w_2 on in), their Adam moments the same slice; the rest,
    the critic and the GST stay replicated."""
    from toucan_tpu_torch.dist.tensor_parallel import shard_module, shard_optimizer

    shard_optimizer(state.optimizer, shard_module(state.model, mesh))
    return state


def shard_vocoder_train_state(state, mesh):
    """Put a ``train.vocoder_train.VocoderTrainState`` on the mesh, in
    place: the generator's stage 0 and 1 residual convs keep this rank's
    output channels on 'model' (and their RAdam moments); the 17 critics
    and their optimizer stay replicated."""
    from toucan_tpu_torch.dist.tensor_parallel import shard_module, shard_optimizer

    n_stacks = len(getattr(state.generator, "resblock_kernel_sizes", (0,) * 3))
    shard_optimizer(state.g_optimizer, shard_module(state.generator, mesh, n_stacks))
    return state


def shard_aligner_train_state(state, mesh):
    """An ``AlignerTrainState`` on the mesh: pure data parallel, every
    parameter and moment replicated, so the state is returned as it is."""
    return state
