"""caco_base.embed_10s on the CPU: 1-s buffers, buckets of 4, 10 clips."""

from tiny_cells import caco as config  # noqa: F401

TRAFFIC = dict(buffer_seconds=1.0, batch_size=4, pool_clips=10, passes=1,
               short_seconds=[0.3, 1.0], check_clips=4, profile_calls=1)
