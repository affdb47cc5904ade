from toucan_tpu_torch.dist.mesh import (
    all_gather,
    initialize_distributed,
    make_global_batch,
    make_mesh,
    param_sharding_rules,
    ppermute,
    shard_aligner_train_state,
    shard_train_state,
    shard_vocoder_train_state,
)
