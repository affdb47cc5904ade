"""Train a recipe: the twin of ``run_training_pipeline.py``.

    python -m toucan_tpu_torch.run.training_pipeline tt_it [--device cpu]
        [--corpora_root DIR] [--model_save_dir DIR] [--resume] ...

The flags are ``toucan_tpu_torch/cli.py``'s.
"""

from toucan_tpu_torch.cli import main

if __name__ == "__main__":
    main()
