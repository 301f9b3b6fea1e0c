from tethys_tpu_torch.audio.frontend import (  # noqa: F401
    extract_fbank_features,
    frame_signal,
    hann_window,
    linear_to_mel_weight_matrix,
    log_mel_features,
    prepare_input_features,
)
from tethys_tpu_torch.audio.logmel import fused_log_mel  # noqa: F401
