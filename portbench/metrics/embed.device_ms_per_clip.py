"""The card's own time per clip embedded: the union of its device
intervals over the profiled stretch of embedding calls ÷ the clips those
calls embedded, ms.  The host's speed, which sets `audio_clips_per_s`
while the card waits on the fill and the launches, does not move it."""


def read(c):
    t, clips = c.get("trace"), c.get("profiled_clips")
    if t is None or not t.kernels or not clips:
        return None
    return 1e3 * t.busy_s() / clips
