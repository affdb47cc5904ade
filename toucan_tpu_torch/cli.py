"""Training CLI (``run_training_pipeline.py`` equivalent).

Counterpart of ``toucan_tpu/cli.py``: dispatches the named recipes with
the reference's flag surface (pipeline name, --resume_checkpoint,
--resume, --finetune, --model_save_dir, --wandb; fixed seed 131714), JAX's
mesh and multi-process flags, and ``--device``, as the ``run/`` twins have
it: the recipes run on the card unless ``--device cpu`` is given.  With
--distributed, --coordinator, --num_processes, --process_id or
``TOUCAN_COORDINATOR`` set, the process joins a process group first
(``dist/mesh.py::initialize_distributed``), over NCCL on the card (each
rank on card ``rank % cards``) and over gloo with ``--device cpu``.

    python -m toucan_tpu_torch.cli tt_it --device cpu --corpora_root DIR

Importing this module imports no recipe: ``build_pipeline_dict`` does.
"""

from __future__ import annotations

import argparse
import os

SEED = 131714


def build_pipeline_dict():
    from toucan_tpu_torch.recipes import (
        aligner_pipeline,
        avocodo_pipeline,
        bigvgan_pipeline,
        embedding_pipeline,
        finetuning_example,
        fs_embedding_integration_test_pipeline,
        integration_test_pipeline,
        meta_pipeline,
        nancy_pipeline,
        stochastic_nancy_pipeline,
    )
    return {
        "nancy": nancy_pipeline,
        "nancystoch": stochastic_nancy_pipeline,
        "meta": meta_pipeline,
        "fine_ex": finetuning_example,
        "tt_it": integration_test_pipeline,
        "fs_it": fs_embedding_integration_test_pipeline,
        "aligner": aligner_pipeline,
        "embedding": embedding_pipeline,
        "avocodo": avocodo_pipeline,
        "bigvgan": bigvgan_pipeline,
    }


def _join_process_group(args) -> str:
    """Join the process group over NCCL (the card) or gloo (--device cpu);
    returns the device the recipes run on."""
    from toucan_tpu_torch.dist.mesh import initialize_distributed

    on_cpu = args.device is not None and args.device.startswith("cpu")
    initialize_distributed(coordinator_address=args.coordinator,
                           num_processes=args.num_processes, process_id=args.process_id,
                           backend="gloo" if on_cpu else "nccl")
    if args.device is not None:
        return args.device
    import torch

    card = torch.distributed.get_rank() % torch.cuda.device_count()
    torch.cuda.set_device(card)
    return f"cuda:{card}"


def main(argv=None):
    pipeline_dict = build_pipeline_dict()
    parser = argparse.ArgumentParser(description="IMS-Toucan training on PyTorch")
    parser.add_argument("pipeline", choices=sorted(pipeline_dict),
                        help="recipe to run")
    parser.add_argument("--n_data", type=int, default=None,
                        help="data-parallel mesh extent (default: all ranks)")
    parser.add_argument("--n_model", type=int, default=1,
                        help="tensor-parallel mesh extent")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="rank 0's address host:port (or env TOUCAN_COORDINATOR)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="process count (or env TOUCAN_NUM_PROCESSES)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank (or env TOUCAN_PROCESS_ID)")
    parser.add_argument("--distributed", action="store_true",
                        help="join a process group even with no explicit coordinator "
                             "flags (the address, size and rank then come from the "
                             "environment, torchrun's included)")
    parser.add_argument("--device", default=None,
                        help="torch device, e.g. cpu (default: the card)")
    parser.add_argument("--resume_checkpoint", type=str, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--finetune", action="store_true")
    parser.add_argument("--model_save_dir", type=str, default=None)
    parser.add_argument("--corpora_root", type=str, default=None)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--wandb_resume_id", type=str, default=None)
    args = parser.parse_args(argv)

    if args.corpora_root:
        os.environ["TOUCAN_CORPORA_ROOT"] = args.corpora_root

    device = args.device
    if (args.distributed or args.coordinator or args.num_processes is not None
            or args.process_id is not None
            or "TOUCAN_COORDINATOR" in os.environ):
        device = _join_process_group(args)

    if args.wandb:
        try:
            import wandb
            wandb.init(name=f"{args.pipeline}", resume="must"
                       if args.wandb_resume_id else None,
                       id=args.wandb_resume_id)
        except ImportError:
            print("wandb not installed; continuing without logging")
            args.wandb = False

    return pipeline_dict[args.pipeline](
        resume_checkpoint=args.resume_checkpoint,
        resume=args.resume,
        finetune=args.finetune,
        model_dir=args.model_save_dir,
        use_wandb=args.wandb,
        n_data=args.n_data,
        n_model=args.n_model,
        seed=SEED,
        device=device,
    )


if __name__ == "__main__":
    main()
