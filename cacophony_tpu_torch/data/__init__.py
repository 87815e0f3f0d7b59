from cacophony_tpu_torch.data.tokenizer import ByteLevelBPETokenizer, load_tokenizer  # noqa: F401
