from toucan_tpu_torch.frontend.inventory import (
    CTC_BLANK_ID,
    NUM_CTC_SYMBOLS,
    NUM_FEATURES,
    feature_index,
    phone_feature_matrix,
    phone_ids,
    phone_vectors,
)
from toucan_tpu_torch.frontend.text import TextFrontend, language_id, SUPPORTED_LANGUAGES
