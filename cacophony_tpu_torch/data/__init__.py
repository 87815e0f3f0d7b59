from cacophony_tpu_torch.data.audio_io import load_audio, read_wav  # noqa: F401
from cacophony_tpu_torch.data.tokenizer import ByteLevelBPETokenizer, load_tokenizer  # noqa: F401
