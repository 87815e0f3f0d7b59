"""Hand-written CUDA kernels of K1, their plain PyTorch versions, and the build.

The sources live in `cacophony_tpu_torch/csrc/` and are compiled by `nvcc`
into one shared library with a plain C interface, loaded with ctypes (no
PyTorch headers, so the build takes seconds).  The build runs at the first
launch, never at import, into `cacophony_tpu_torch/_build/` (listed in
.gitignore); the library name carries a hash of the sources, so an edited
source is rebuilt.  A failed build raises.

Each kernel has three things here:
- a plain PyTorch version (`*_plain`) with the kernel's numerics, on any
  device: the CPU tests run it, and chip_smoke.py holds the kernel to it;
- a wrapper (`layer_norm`, `gemm`, `attention`) that runs the plain version
  for a tensor on the CPU and launches the kernel for a CUDA tensor — it
  checks device, dtype, shape and contiguity and raises on anything the
  kernel does not take; it never falls back;
- a launch count in `LAUNCHES`, incremented where the kernel is launched
  and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

# dtype and epilogue codes shared with csrc/k1_common.cuh
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
EPI_BIAS, EPI_BIAS_RESID_F32, EPI_BIAS_SILU, EPI_BIAS_CAST_ADD = range(4)

LAUNCHES: Dict[str, int] = {"layer_norm": 0, "gemm": 0, "attention": 0}

_VSCALE = 2.0 ** -24
_SOFTMAX_CLAMP = 80.0
_NEG_INF = -1e30
_ROWSUM_FLOOR = 1e-37


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------- build

class KernelBuildError(RuntimeError):
    pass


_lib: Optional[ctypes.CDLL] = None
build_log: str = ""


def _sources():
    return sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    path = os.path.join(BUILD_DIR, f"libk1_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[os.path.join(CSRC, f) for f in _sources() if f.endswith(".cu")]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.k1_layer_norm.argtypes = [i, p, p, p, p, i, i, f, p]
    lib.k1_gemm.argtypes = [i, i, p, p, p, p, p, i, i, i, p]
    lib.k1_attention.argtypes = [i, p, p, p, i, i, i, i, f, p]
    for fn in (lib.k1_layer_norm, lib.k1_gemm, lib.k1_attention):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch `k1_<name>` on `device`'s current stream, count it, and raise
    if the launch was refused (cudaGetLastError right after it)."""
    fn = getattr(load_library(), f"k1_{name}")
    with torch.cuda.device(device):
        LAUNCHES[name] += 1
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 kernel {name}: CUDA error {err} at launch")


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"K1 kernel does not take this input: {what}")


def _device_kind(*ts: torch.Tensor) -> str:
    devices = {t.device for t in ts if t is not None}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len(devices) == 1:
        return "cuda"
    raise ValueError(f"K1 kernels take all-CPU or all-CUDA tensors on one device, "
                     f"got {sorted(map(str, devices))}")


def _check_common(x: torch.Tensor, *f32: torch.Tensor) -> None:
    _need(x.dtype in _DTYPE_CODE, f"dtype {x.dtype}")
    _need(x.is_contiguous(), "non-contiguous activation")
    for t in f32:
        _need(t.dtype == torch.float32 and t.is_contiguous(), "bias/scale must be contiguous fp32")


# -------------------------------------------------------------- layer norm

def layer_norm_plain(x, scale, bias, eps: float):
    """fp32 statistics, (x - mean) * rsqrt(var + eps) * scale + bias, cast."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def layer_norm(x, scale, bias, eps: float):
    """Row LayerNorm over the last axis (csrc/layer_norm.cu)."""
    if _device_kind(x, scale, bias) == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _check_common(x, scale, bias)
    cols = x.shape[-1]
    rows = x.numel() // cols
    _need(rows > 0 and scale.numel() == cols and bias.numel() == cols, "shape")
    out = torch.empty_like(x)
    _launch("layer_norm", x.device, _DTYPE_CODE[x.dtype], x.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), rows, cols, float(eps))
    return out


# -------------------------------------------------------------------- gemm

def gemm_plain(a, w, bias, epilogue: int, resid=None):
    """T(epilogue(a @ w + bias)) with fp32 accumulation: the operands are
    upcast, so each bf16 product is exact and the sum is fp32."""
    h = a.float() @ w.float() + bias
    dt = a.dtype
    if epilogue == EPI_BIAS:
        return h.to(dt)
    if epilogue == EPI_BIAS_RESID_F32:
        return (h + resid.float()).to(dt)
    if epilogue == EPI_BIAS_SILU:
        return (h * torch.sigmoid(h)).to(dt)
    if epilogue == EPI_BIAS_CAST_ADD:
        return (h.to(dt).float() + resid.float()).to(dt)
    raise ValueError(f"unknown epilogue {epilogue}")


def gemm(a, w, bias, epilogue: int, resid=None):
    """(..., K) @ (K, N) + bias with a fused epilogue (csrc/gemm.cu)."""
    if _device_kind(a, w, bias, resid) == "cpu":
        return gemm_plain(a, w, bias, epilogue, resid)
    _check_common(a, bias)
    k = a.shape[-1]
    m = a.numel() // k
    _need(w.dim() == 2 and w.shape[0] == k and w.dtype == a.dtype and w.is_contiguous(), "weight")
    n = w.shape[1]
    _need(m > 0 and n % 8 == 0 and k % 8 == 0, f"M={m} N={n} K={k} (N, K multiples of 8)")
    _need(bias.numel() == n, "bias width")
    _need(epilogue in (EPI_BIAS, EPI_BIAS_RESID_F32, EPI_BIAS_SILU, EPI_BIAS_CAST_ADD), "epilogue")
    if epilogue in (EPI_BIAS_RESID_F32, EPI_BIAS_CAST_ADD):
        _need(resid is not None and resid.dtype == a.dtype and resid.is_contiguous()
              and resid.numel() == m * n, "residual")
    out = torch.empty(*a.shape[:-1], n, dtype=a.dtype, device=a.device)
    _launch("gemm", a.device, _DTYPE_CODE[a.dtype], epilogue, a.data_ptr(), w.data_ptr(),
            bias.data_ptr(), resid.data_ptr() if resid is not None else None, out.data_ptr(),
            m, n, k)
    return out


# --------------------------------------------------------------- attention

def q_scale(head_dim: int, dtype: torch.dtype) -> float:
    """1/sqrt(Dh) as the Pallas kernel multiplies it: cast to the compute
    dtype first (`_head_logits`, encoder_attention.py:168)."""
    return float(torch.tensor(1.0 / head_dim ** 0.5, dtype=dtype))


def attention_plain(qkv, mask, num_heads: int):
    """The Pallas kernel's masked attention over fused (B, S, 3D) QKV."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    dt = qkv.dtype
    q, k, v = (t.reshape(b, s, num_heads, hd) for t in qkv.split(d, dim=-1))
    qs = (q.float() * q_scale(hd, dt)).to(dt)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    kbias = torch.where(mask[:, None, None, :] > 0, _SOFTMAX_CLAMP, _NEG_INF).to(torch.float32)
    p = torch.exp(torch.minimum(logits, kbias))
    rowsum = p.sum(dim=-1, keepdim=True).clamp_min(_ROWSUM_FLOOR)
    vs = (v.float() * _VSCALE).to(dt)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), vs.float())
    o = (o / rowsum) * (1.0 / _VSCALE)
    return o.permute(0, 2, 1, 3).reshape(b, s, d).to(dt)


def attention(qkv, mask, num_heads: int):
    """(B, S, 3D) fused QKV + (B, S) key mask → (B, S, D) (csrc/attention.cu)."""
    if _device_kind(qkv, mask) == "cpu":
        return attention_plain(qkv, mask, num_heads)
    _check_common(qkv)
    _need(qkv.dim() == 3 and qkv.shape[-1] % (3 * num_heads) == 0, "qkv shape")
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    _need(mask.shape == (b, s) and mask.dtype == torch.int32 and mask.is_contiguous(),
          "mask must be contiguous int32 (B, S)")
    if qkv.dtype == torch.bfloat16:
        _need(hd in (64, 96), f"bf16 head dim {hd} (64 or 96)")
    else:
        _need(0 < hd <= 96, f"fp32 head dim {hd} (at most 96)")
    _need(b > 0 and s > 0 and qkv.data_ptr() % 16 == 0, "empty or misaligned qkv")
    out = torch.empty(b, s, d, dtype=qkv.dtype, device=qkv.device)
    _launch("attention", qkv.device, _DTYPE_CODE[qkv.dtype], qkv.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, s, num_heads, hd, q_scale(hd, qkv.dtype))
    return out
