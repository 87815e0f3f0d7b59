from cacophony_tpu_torch.ops.attention import multi_head_attention  # noqa: F401
