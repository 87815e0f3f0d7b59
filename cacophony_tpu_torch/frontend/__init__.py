from cacophony_tpu_torch.frontend.dsp import (  # noqa: F401
    hann_window_periodic,
    linear_to_mel_matrix,
    log_mel_spectrogram,
    num_stft_frames,
    resample_fft,
    resample_fft_host,
    stft_magnitude,
)
from cacophony_tpu_torch.frontend.fused import (  # noqa: F401
    fused_batch_wav_to_patches,
    fused_log_mel,
    patch_index_arrays,
)
from cacophony_tpu_torch.frontend.patchify import (  # noqa: F401
    num_patches_for_samples,
    patchify_spectrogram,
    wav_to_patches,
)
