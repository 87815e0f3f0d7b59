"""The GEMMs' share of their roofline in the profiled embedding calls: the
least time of the frontend's fp32 DFT and mel products and the bf16 patch
projection, QKV, o-projection, MLP and pooler products over the valid
frames and patches, bucket by bucket (the driver's `gemm_least_s`, from
work.py) ÷ the device time of the GEMM-class kernels (work.is_gemm)."""

from portbench import work


def read(c):
    t = c.get("trace")
    busy = t.busy_s(work.is_gemm) if t is not None else 0.0
    if busy <= 0 or not c.get("gemm_least_s"):
        return None
    return 100.0 * c["gemm_least_s"] / busy
