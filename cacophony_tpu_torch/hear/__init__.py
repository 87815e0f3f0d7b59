from cacophony_tpu_torch.hear.embeddings import CacoHearEmbedder, AudioMAEHearEmbedder  # noqa: F401
