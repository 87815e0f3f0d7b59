"""The bulk-embedding pipeline's share of the card's bf16 peak: the frozen
matmul FLOP of one buffer-long clip (frontend DFT and mel, encoder at the
buffer's valid patches, pooler; the driver's `flops_per_unit`) × the
window's clips/s ÷ the peak for the card's name.  Taken from the traced
run's window, before the profiler."""

from portbench import frozen


def read(c):
    peak = frozen.device_peak_flops(c.get("device_name", ""))
    if peak is None or not c.get("units_per_s") or not c.get("flops_per_unit"):
        return None
    return 100.0 * c["flops_per_unit"] * c["units_per_s"] / peak
