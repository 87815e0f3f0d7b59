from cacophony_tpu_torch.checkpoints.bridge import jax_state_dict, params_from_jax  # noqa: F401
from cacophony_tpu_torch.checkpoints.convert import (  # noqa: F401
    convert_audio_decoder,
    convert_audio_encoder,
    convert_audiomae_params,
    convert_caco_params,
    convert_caption_decoder,
    convert_text_encoder,
)
from cacophony_tpu_torch.checkpoints.io import (  # noqa: F401
    load_audiomae,
    load_caco,
    load_params,
    save_params,
)
