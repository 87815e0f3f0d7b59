"""Hand-written CUDA kernels, the build, and their plain PyTorch versions.

The sources live in `cacophony_tpu_torch/csrc/` and are compiled by `nvcc`
into one shared library with a plain C interface, loaded with ctypes (no
PyTorch headers, so the build takes seconds).  Each `.cu` file is compiled
by its own `nvcc` process, all started together, and the objects are linked
into one library.  The build runs at the first launch, never at import,
into `cacophony_tpu_torch/_build/` (listed in .gitignore); the library name
carries a hash of the sources, so an edited source is rebuilt.  A failed
build raises.

Each kernel has three things:
- a plain PyTorch version (`*_plain`) with the kernel's numerics, on any
  device: the CPU tests run it, and chip_smoke.py holds the kernel to it;
- a wrapper (`layer_norm`, `gemm`, `attention`, `attention_k4`,
  `attention_k5`, `attention_bwd`, `table_grad` here; `fused_log_mel` in
  frontend/fused.py)
  that runs the plain version for a tensor on the CPU
  and launches the kernel for a CUDA tensor — it checks device, dtype,
  shape and contiguity and raises on anything the kernel does not take; it
  never falls back;
- a launch count in `LAUNCHES`, incremented where the kernel is launched
  and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
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
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

# dtype and epilogue codes shared with csrc/k1_common.cuh
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
EPI_BIAS, EPI_BIAS_RESID_F32, EPI_BIAS_SILU, EPI_BIAS_CAST_ADD = range(4)

# One count per wrapper: "attention" is the attention inside the K1/K2/K3
# (and K3′/K6) chains, "k4" and "k5" the stand-alone attention kernels, "k7"
# K4's backward (one count per call, which launches its two or three CUDA
# kernels),
# "log_mel" K8 and "log_mel_fast" its bf16×3 form K8′, "table_grad" the
# gradient of a gather from a small table (one count per call, two CUDA
# kernels).
LAUNCHES: Dict[str, int] = {"layer_norm": 0, "gemm": 0, "attention": 0, "k4": 0, "k5": 0,
                            "k7": 0, "log_mel": 0, "log_mel_fast": 0, "table_grad": 0}
# launch-count key → C entry point
_SYMBOLS = {"layer_norm": "k1_layer_norm", "gemm": "k1_gemm", "attention": "caco_attention",
            "k4": "caco_attention", "k5": "caco_attention", "k7": "caco_attention_bwd",
            "log_mel": "k8_log_mel", "log_mel_fast": "k8_log_mel_fast",
            "table_grad": "table_grad"}

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


def _compile(out: str) -> None:
    """One nvcc process per .cu file, all started together, then one link."""
    global build_log
    nvcc = _nvcc()
    units = [f for f in _sources() if f.endswith(".cu")]
    objs = [os.path.join(os.path.dirname(out), f"{os.path.basename(out)}.{u}.o") for u in units]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, u)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for u, o in zip(units, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        failed = [(u, p.returncode) for u, p in zip(units, procs) if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", out, *objs], capture_output=True,
                                  text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed = [("link", link.returncode)]
    finally:
        for o in objs:
            if os.path.exists(o):
                os.unlink(o)
    build_log = "".join(logs)
    if failed:
        raise KernelBuildError(f"nvcc failed {failed}:\n{build_log}")


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    path = os.path.join(BUILD_DIR, f"libcaco_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            _compile(tmp)
        except BaseException:
            os.unlink(tmp)
            raise
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.k1_layer_norm.argtypes = [i, p, p, p, p, i, i, f, p]
    lib.k1_gemm.argtypes = [i, i, p, p, p, p, p, i, i, i, p]
    lib.caco_attention.argtypes = [i, p, p, p, i, i, p, p, i, i, i, i, f, i, p]
    lib.caco_attention_bwd.argtypes = [i, p, p, p, p, p, p, i, i, i, i, f, f, i, p]
    lib.k8_log_mel.argtypes = [p, p, p, p, i, p, *[i] * 9, f, f, f, p]
    lib.k8_log_mel_fast.argtypes = [p, p, p, p, p, i, p, *[i] * 9, f, f, f, p]
    lib.table_grad.argtypes = [i, i, p, p, i, i, i, i, p, p, p]
    lib.k1_silu_sweep.argtypes = [p, p]
    lib.k1_silu_sweep.restype = ctypes.c_int
    for sym in set(_SYMBOLS.values()):
        getattr(lib, sym).restype = ctypes.c_int
    _lib = lib
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch the kernel counted as `name` on `device`'s current stream,
    count it, and raise if the launch was refused (cudaGetLastError right
    after it)."""
    fn = getattr(load_library(), _SYMBOLS[name])
    with torch.cuda.device(device):
        LAUNCHES[name] += 1
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel {name}: CUDA error {err} at launch")


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"kernel does not take this input: {what}")


def _device_kind(*ts: torch.Tensor) -> str:
    devices = {t.device for t in ts if t is not None}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len(devices) == 1:
        return "cuda"
    raise ValueError(f"kernels take all-CPU or all-CUDA tensors on one device, "
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


def gemm_operands(a, w, bias, epilogue: int, resid=None):
    """The GEMM kernel's contract → (M, N, K); raises ValueError on what
    csrc/gemm.cu does not take.  Host-side only, so it runs on any device.
    Any M, N, K ≥ 1: bf16 operands TMA can describe (N and K multiples of
    8, 16-byte aligned bases) run the wgmma kernel, the rest (and fp32) the
    SIMT kernel."""
    _check_common(a, bias)
    k = a.shape[-1]
    m = a.numel() // k if k else 0
    _need(w.dim() == 2 and w.shape[0] == k and w.dtype == a.dtype and w.is_contiguous(), "weight")
    n = w.shape[1]
    _need(m > 0 and n > 0 and k > 0, f"M={m} N={n} K={k} (each at least 1)")
    _need(bias.numel() == n, "bias width")
    _need(epilogue in (EPI_BIAS, EPI_BIAS_RESID_F32, EPI_BIAS_SILU, EPI_BIAS_CAST_ADD), "epilogue")
    if epilogue in (EPI_BIAS_RESID_F32, EPI_BIAS_CAST_ADD):
        _need(resid is not None and resid.dtype == a.dtype and resid.is_contiguous()
              and resid.numel() == m * n, "residual")
    else:
        resid = None
    return m, n, k


def gemm(a, w, bias, epilogue: int, resid=None):
    """(..., K) @ (K, N) + bias with a fused epilogue (csrc/gemm.cu)."""
    if _device_kind(a, w, bias, resid) == "cpu":
        return gemm_plain(a, w, bias, epilogue, resid)
    m, n, k = gemm_operands(a, w, bias, epilogue, resid)
    out = torch.empty(*a.shape[:-1], n, dtype=a.dtype, device=a.device)
    _launch("gemm", a.device, _DTYPE_CODE[a.dtype], epilogue, a.data_ptr(), w.data_ptr(),
            bias.data_ptr(), resid.data_ptr() if resid is not None else None, out.data_ptr(),
            m, n, k)
    return out


def silu_epilogue_mismatches(device="cuda") -> int:
    """The bf16 GEMM's branch-free silu epilogue against apply_epilogue's
    division, over every fp32 input bit pattern on the card: the number of
    results whose bits differ (csrc/gemm.cu:k1_silu_sweep; 0 expected)."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(count.device):
        err = load_library().k1_silu_sweep(count.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"k1_silu_sweep: CUDA error {err} at launch")
    return int(count.item())


# --------------------------------------------------------------- attention

def q_scale(head_dim: int, dtype: torch.dtype) -> float:
    """1/sqrt(Dh) as the Pallas kernel multiplies it: cast to the compute
    dtype first (`_head_logits`, encoder_attention.py:168)."""
    return float(torch.tensor(1.0 / head_dim ** 0.5, dtype=dtype))


def ds_scale(head_dim: int) -> float:
    """1/sqrt(Dh) as the backward kernel multiplies dS: fp32
    (`_bwd_kernel`, encoder_attention.py:1118, :1134)."""
    return float(torch.tensor(1.0 / head_dim ** 0.5, dtype=torch.float32))


def split_heads(t, num_heads):
    """(B, S, H·Dh) → (B, H, S, Dh)."""
    b, s, d = t.shape
    return t.reshape(b, s, num_heads, d // num_heads).permute(0, 2, 1, 3)


def merge_heads(t):
    """(B, H, S, Dh) → (B, S, H·Dh)."""
    b, h, s, hd = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, s, h * hd)


def _kbias(mask, s: int, causal: bool):
    """The per-key bias of the max-free softmax, (B, 1, 1 or S, S) fp32:
    80 where a key may be attended, -1e30 elsewhere (`_softmax_kbias`,
    `_softmax_kbias_causal`, encoder_attention.py:137-161)."""
    allowed = mask[:, None, None, :] > 0
    if causal:
        allowed = allowed & torch.ones(s, s, dtype=torch.bool, device=mask.device).tril()
    return torch.where(allowed, _SOFTMAX_CLAMP, _NEG_INF).to(torch.float32)


def attention_core_plain(q, k, v, mask, num_heads: int, causal: bool = False):
    """The Pallas kernels' masked attention with q, k, v each (B, S, H·Dh)
    (views of a fused QKV are fine) → (B, S, H·Dh)."""
    dt, s = q.dtype, q.shape[1]
    hd = q.shape[-1] // num_heads
    q, k, v = split_heads(q, num_heads), split_heads(k, num_heads), split_heads(v, num_heads)
    qs = (q.float() * q_scale(hd, dt)).to(dt)
    logits = qs.float() @ k.float().transpose(-1, -2)
    p = torch.exp(torch.minimum(logits, _kbias(mask, s, causal)))
    rowsum = p.sum(dim=-1, keepdim=True).clamp_min(_ROWSUM_FLOOR)
    vs = (v.float() * _VSCALE).to(dt)
    o = p.to(dt).float() @ vs.float()
    return merge_heads((o / rowsum) * (1.0 / _VSCALE)).to(dt)


def attention_plain(qkv, mask, num_heads: int, causal: bool = False):
    """The Pallas kernel's masked attention over fused (B, S, 3D) QKV."""
    return attention_core_plain(*qkv.chunk(3, dim=-1), mask, num_heads, causal)


def attention_split_plain(q, kv, mask, num_heads: int):
    """The same over separate Q (B, S, D) and K|V (B, S, 2D) (K5's operands)."""
    return attention_core_plain(q, *kv.chunk(2, dim=-1), mask, num_heads)


def attention_operands(q, k, v, q_row: int, kv_row: int, mask, num_heads: int):
    """The attention kernel's contract → (B, S, D, Dh); raises ValueError
    on what csrc/attention.cu does not take.  Host-side only.  Any head
    dim, any alignment: the kernel reads 16 bytes at a time where the rows
    allow it (bf16 at Dh 64 or 96 then runs on wgmma + TMA) and element by
    element elsewhere; a head past 128 columns runs in pieces of 128."""
    b, s, d = q.shape[0], q.shape[1], q.shape[-1]
    hd = d // num_heads
    _need(q.dtype in _DTYPE_CODE and k.dtype == q.dtype and v.dtype == q.dtype, f"dtype {q.dtype}")
    _need(d % num_heads == 0, f"width {d} with {num_heads} heads")
    _need(mask.shape == (b, s) and mask.dtype == torch.int32 and mask.is_contiguous(),
          "mask must be contiguous int32 (B, S)")
    _need(b > 0 and s > 0 and hd > 0, "empty q/k/v")
    _need(all(t.stride(-1) == 1 and t.stride(1) == row and t.stride(0) == s * row
              for t, row in ((q, q_row), (k, kv_row), (v, kv_row))),
          "q/k/v rows must be the given row strides apart, clips S rows apart")
    return b, s, d, hd


def _attention_launch(counter: str, q, k, v, q_row: int, kv_row: int, mask, num_heads: int,
                      causal: bool):
    b, s, d, hd = attention_operands(q, k, v, q_row, kv_row, mask, num_heads)
    out = torch.empty(b, s, d, dtype=q.dtype, device=q.device)
    _launch(counter, q.device, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_row, kv_row, mask.data_ptr(), out.data_ptr(), b, s, num_heads, hd,
            q_scale(hd, q.dtype), int(causal))
    return out


def _fused_qkv_launch(counter: str, qkv, mask, num_heads: int, causal: bool):
    _check_common(qkv)
    _need(qkv.dim() == 3 and qkv.shape[-1] % (3 * num_heads) == 0, "qkv shape")
    q, k, v = qkv.chunk(3, dim=-1)
    return _attention_launch(counter, q, k, v, qkv.shape[-1], qkv.shape[-1], mask, num_heads,
                             causal)


def attention(qkv, mask, num_heads: int):
    """The attention inside the K1/K2/K3 chains: (B, S, 3D) fused QKV +
    (B, S) key mask → (B, S, D) (csrc/attention.cu)."""
    if _device_kind(qkv, mask) == "cpu":
        return attention_plain(qkv, mask, num_heads)
    return _fused_qkv_launch("attention", qkv, mask, num_heads, False)


def attention_k4(qkv, mask, num_heads: int, causal: bool = False):
    """K4 (`_pallas_forward`): the same attention as a kernel of its own,
    optionally causal (csrc/attention.cu)."""
    if _device_kind(qkv, mask) == "cpu":
        return attention_plain(qkv, mask, num_heads, causal)
    return _fused_qkv_launch("k4", qkv, mask, num_heads, causal)


def attention_k5(q, kv, mask, num_heads: int):
    """K5 (`_pallas_forward_blocked`) at the length it is given: Q (B, S, D)
    and K|V (B, S, 2D) → (B, S, D) (csrc/attention.cu).  The padding to the
    blocked plan's length is the caller's (ops/encoder_attention.py)."""
    if _device_kind(q, kv, mask) == "cpu":
        return attention_split_plain(q, kv, mask, num_heads)
    _check_common(q)
    _check_common(kv)
    _need(q.dim() == 3 and kv.shape == (*q.shape[:2], 2 * q.shape[-1]), "q / kv shapes")
    k, v = kv.chunk(2, dim=-1)
    return _attention_launch("k5", q, k, v, q.shape[-1], kv.shape[-1], mask, num_heads, False)


def attention_bwd_plain(qkv, mask, g, num_heads: int, causal: bool = False):
    """K7 (`_bwd_kernel`, encoder_attention.py:1100-1144): d qkv of K4's
    attention for the output gradient g, in the fused (B, S, 3D) layout.
    Products of compute-dtype operands sum in fp32; P and dS are rounded to
    the compute dtype T where the kernel rounds them."""
    dt, s = qkv.dtype, qkv.shape[1]
    q, k, v = (split_heads(t, num_heads).float() for t in qkv.chunk(3, dim=-1))
    go = split_heads(g.to(dt), num_heads).float()
    hd = q.shape[-1]
    logits = (q * q_scale(hd, dt)).to(dt).float() @ k.transpose(-1, -2)
    p = torch.exp(torch.minimum(logits, _kbias(mask, s, causal)))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(_ROWSUM_FLOOR)
    dv = p.to(dt).float().transpose(-1, -2) @ go
    dp = go @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = torch.where(mask[:, None, None, :] > 0, ds, 0.0) * ds_scale(hd)
    dsb = ds.to(dt).float()
    dq, dk = dsb @ k, dsb.transpose(-1, -2) @ q
    return torch.cat([merge_heads(t) for t in (dq, dk, dv)], dim=-1).to(dt)


def attention_bwd(qkv, mask, g, num_heads: int, causal: bool = False):
    """K7: d qkv (B, S, 3D) for the output gradient g (B, S, D)
    (csrc/attention_bwd.cu).  bf16 at Dh 64 and 96: a pre-pass per query
    tile for the row sums and Δ, a main pass per key tile for dK, dV and dQ
    (fp32 atomics into the `dq_acc` scratch), a conversion of dQ; any other
    head: a pass per query tile for the row sums, Δ and dQ, then a pass per
    key tile for dK and dV."""
    if _device_kind(qkv, mask, g) == "cpu":
        return attention_bwd_plain(qkv, mask, g, num_heads, causal)
    _check_common(qkv)
    _need(qkv.dim() == 3 and qkv.shape[-1] % (3 * num_heads) == 0, "qkv shape")
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    _need(g.shape == (b, s, d) and g.dtype == qkv.dtype and g.is_contiguous(),
          "g must be contiguous (B, S, D) in qkv's dtype")
    _need(mask.shape == (b, s) and mask.dtype == torch.int32 and mask.is_contiguous(),
          "mask must be contiguous int32 (B, S)")
    _need(b > 0 and s > 0 and hd > 0, "empty qkv")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(2 * b * num_heads * s, dtype=torch.float32, device=qkv.device)
    dq_acc = (torch.empty(b, s, d, dtype=torch.float32, device=qkv.device)
              if qkv.dtype == torch.bfloat16 else None)
    _launch("k7", qkv.device, _DTYPE_CODE[qkv.dtype], qkv.data_ptr(), mask.data_ptr(),
            g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            dq_acc.data_ptr() if dq_acc is not None else None, b, s, num_heads, hd,
            q_scale(hd, qkv.dtype), ds_scale(hd), int(causal))
    return dqkv


# -------------------------------------------------- gather from a small table

# csrc/table_grad.cu keeps an fp32 (n_rows, D) accumulator a CTA in 48 KB of
# shared memory; its grid is at most TABLE_GRAD_CTAS_PER_SM CTAs an SM, each
# over at least TABLE_GRAD_MIN_ROWS rows.
TABLE_GRAD_MAX_FLOATS = 48 * 1024 // 4
TABLE_GRAD_CTAS_PER_SM = 4
TABLE_GRAD_MIN_ROWS = 64


def table_grad_plain(g, inds, n_rows: int):
    """The rows of g (N, D) summed into the table row each index of inds
    (N,) names, in fp32 → (n_rows, D): the gradient of `table[inds]`."""
    out = torch.zeros(n_rows, g.shape[-1], dtype=torch.float32, device=g.device)
    return out.index_add_(0, inds.long(), g.float())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def table_grad(g, inds, n_rows: int):
    """`table_grad_plain` by csrc/table_grad.cu: one wave of CTAs sums
    slices of the rows into fp32 partial tables in shared memory, a second
    pass sums the partials in a fixed order, so a call repeats bit for bit.
    Rows whose index lies outside [0, n_rows) add nothing on the card."""
    if _device_kind(g, inds) == "cpu":
        return table_grad_plain(g, inds, n_rows)
    _check_common(g)
    _need(g.dim() == 2, "g must be (N, D)")
    n, width = g.shape
    _need(inds.shape == (n,) and inds.dtype in (torch.int32, torch.int64)
          and inds.is_contiguous(), "inds must be contiguous int32 or int64 (N,)")
    _need(0 < n_rows * width <= TABLE_GRAD_MAX_FLOATS,
          f"a table of {n_rows} x {width} (at most {TABLE_GRAD_MAX_FLOATS} fp32 values)")
    n_cta = max(1, min(-(-n // TABLE_GRAD_MIN_ROWS),
                       TABLE_GRAD_CTAS_PER_SM * _sm_count(g.device.index)))
    partial = torch.empty(n_cta, n_rows, width, dtype=torch.float32, device=g.device)
    out = torch.empty(n_rows, width, dtype=torch.float32, device=g.device)
    _launch("table_grad", g.device, _DTYPE_CODE[g.dtype], 64 if inds.dtype == torch.int64 else 32,
            g.data_ptr(), inds.data_ptr(), n, width, n_rows, n_cta, partial.data_ptr(),
            out.data_ptr())
    return out
