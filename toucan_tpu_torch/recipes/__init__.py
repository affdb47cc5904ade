from toucan_tpu_torch.recipes.pipelines import (
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
