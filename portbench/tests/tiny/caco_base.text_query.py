"""caco_base.text_query on the CPU: 16 prompts, a gallery of 5000 rows."""

from tiny_cells import caco as config  # noqa: F401

TRAFFIC = dict(batch_size=4, text_len=12, prompts=16, prompt_tokens=[3, 10], gallery_rows=5000,
               slab_rows=1024, profile_queries=3, check_queries=8)
