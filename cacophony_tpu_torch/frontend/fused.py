"""K8 and K8′, the fused frontend: waveform → log-mel in one kernel
(cacophony_tpu/frontend/fused.py).

Audio arrives as hop-major rows (B, R, hop), a free reshape of the
zero-padded buffer (`buffer_to_rows`).  The kernel (csrc/log_mel.cu,
replacing the Pallas `fused_log_mel:153`) runs the windowed DFT against
the lane-padded re|im matrix, the magnitude, the mel product and the log,
and writes only the (B, F, num_mels) log-mel.

- K8 (fast_dft=False): both products full fp32.  Its output equals the
  unfused chain (frontend/dsp.py) up to the order of fp32 sums, so
  choosing it changes no result.  It computes only what the log-mel
  needs (`mel_bin_tables`): the DFT over the bins whose mel row has a
  nonzero, the mel product over each channel's run of nonzero bins.
- K8′ (fast_dft=True, JAX's `_kernel:135-141`): the DFT as three bf16
  products with fp32 accumulation — audio and matrix each split into a
  bf16 pair hi + lo, the sum hi·hi + hi·lo + lo·hi, lo·lo dropped (about
  16 mantissa bits) — on the tensor cores; the mel product stays fp32.

The patchify transpose and the masks stay in PyTorch, as they stay in XLA
in the JAX package.  The JAX package's `fused_batch_wav_to_patches` runs
its kernel only where one clip fits the TPU's VMEM (`fits_vmem`: 10-s
buffers, not 30-s ones) and the exact XLA chain elsewhere, so there
`fast_dft` has no effect; the port keeps that rule and runs K8 there.
K8's Hopper kernel tiles by frame and runs at every buffer length, as
does `fused_log_mel` called directly, in either form.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from cacophony_tpu_torch.configs import FrontendConfig, PatchConfig
from cacophony_tpu_torch.frontend.dsp import _windowed_dft_matrices, linear_to_mel_matrix
from cacophony_tpu_torch.frontend.patchify import patchify_spectrogram
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as _enc_attn


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=8)
def _padded_matrices(front: FrontendConfig):
    """DFT (cos | sin, Hann folded in) and mel matrices, each bin axis
    zero-padded to a multiple of 128 (fused.py:52).  Padded bins are zero
    columns → zero magnitude → times zero mel rows: exact."""
    cr, ci = _windowed_dft_matrices(front.window_length, front.fft_size)
    mel = linear_to_mel_matrix(front)
    nbins = cr.shape[1]
    nbins_pad = _round_up(nbins, 128)
    c = np.concatenate([np.pad(cr, [[0, 0], [0, nbins_pad - nbins]]),
                        np.pad(ci, [[0, 0], [0, nbins_pad - nbins]])], axis=1)
    mel = np.pad(mel, [[0, nbins_pad - nbins], [0, 0]])
    return c, mel, nbins_pad


@functools.lru_cache(maxsize=8)
def _device_matrices(front: FrontendConfig, device: torch.device):
    """The padded matrices on `device`, copied once (a copy from pageable
    host memory waits for the device, so it stays out of the per-bucket path)."""
    c, mel, _ = _padded_matrices(front)
    return torch.from_numpy(c).to(device), torch.from_numpy(mel).to(device)


@functools.lru_cache(maxsize=8)
def mel_bin_tables(front: FrontendConfig):
    """What the log-mel needs of the spectrogram, from the padded mel
    matrix → (k_lo, k_hi, runs, weights):
    - [k_lo, k_hi): the bins whose mel row has a nonzero (1–255 at the
      default frontend: the DC row is zeroed and the top edge is Nyquist);
      every other bin adds exactly 0 to every mel sum;
    - runs (num_mels, 2) int32: channel m's first and last bin with a
      nonzero weight ([0, -1] for a channel with none);
    - weights (num_mels, W) fp32: channel m's weights over its run in bin
      order (interior zeros included), zero past it; W the longest run.
    Summing a channel over its run in ascending bin order with fmaf gives
    the dense ascending sum bit for bit: every term left out is mag·0."""
    mel = _padded_matrices(front)[1]
    nz = mel != 0
    bins = np.flatnonzero(nz.any(axis=1))
    k_lo, k_hi = (int(bins[0]), int(bins[-1]) + 1) if bins.size else (0, 0)
    runs = np.tile(np.array([0, -1], np.int32), (mel.shape[1], 1))
    for m in range(mel.shape[1]):
        ks = np.flatnonzero(nz[:, m])
        if ks.size:
            runs[m] = ks[0], ks[-1]
    weights = np.zeros((mel.shape[1], max(1, int((runs[:, 1] - runs[:, 0] + 1).max()))), np.float32)
    for m, (lo, hi) in enumerate(runs):
        weights[m, :hi - lo + 1] = mel[lo:hi + 1, m]
    return k_lo, k_hi, runs, weights


@functools.lru_cache(maxsize=8)
def _device_mel_tables(front: FrontendConfig, device: torch.device):
    """`mel_bin_tables`' runs and weights on `device`, copied once."""
    _, _, runs, weights = mel_bin_tables(front)
    return torch.from_numpy(runs).to(device), torch.from_numpy(weights).to(device)


def spectrum_work(front: FrontendConfig) -> tuple:
    """(DFT columns, mel terms) per frame that the log-mel needs: 2 columns
    (re, im) for each bin with a nonzero mel row, one term per nonzero of
    the mel matrix.  The kernels' bounds count these."""
    nz = _padded_matrices(front)[1] != 0
    return 2 * int(nz.any(axis=1).sum()), int(nz.sum())


@functools.lru_cache(maxsize=8)
def _device_split_matrices(front: FrontendConfig, device: torch.device):
    """The padded DFT matrix as a bf16 pair (hi, lo) with hi + lo ≈ c to
    ~16 mantissa bits (`_split_bf16`, fused.py:69-73: both rounded to
    nearest even), on `device`, copied once."""
    c = torch.from_numpy(_padded_matrices(front)[0])
    hi = c.to(torch.bfloat16)
    lo = (c - hi.float()).to(torch.bfloat16)
    return hi.to(device), lo.to(device)


def fits_vmem(num_frames: int, front: FrontendConfig) -> bool:
    """The JAX package's rule for running its kernel at all (fused.py:88):
    one clip's rows, fp32 re|im accumulator, magnitude and log-mel within
    the TPU's VMEM budget — 10-s buffers, not 30-s ones.  Here it decides
    only whether `fast_dft` takes effect."""
    rows = audio_rows_for(num_frames, front)
    nbins_pad = _round_up(front.num_spectrogram_bins, 128)
    blocks = rows * front.hop_length * 4 + num_frames * front.num_mels * 4
    scratch = num_frames * 2 * nbins_pad * 4 * 2
    return 2 * blocks + scratch <= _enc_attn.VMEM_BUDGET_BYTES


def audio_rows_for(num_frames: int, front: FrontendConfig) -> int:
    """Rows of the (R, hop) hop-major layout: num_frames + ⌈win / hop⌉."""
    return num_frames + -(-front.window_length // front.hop_length)


def buffer_to_rows(bufs: torch.Tensor, num_frames: int, front: FrontendConfig) -> torch.Tensor:
    """(B, samples) zero-padded buffers → (B, R, hop) hop-major rows (a pad
    and a reshape)."""
    need = audio_rows_for(num_frames, front) * front.hop_length
    b, s = bufs.shape
    bufs = torch.nn.functional.pad(bufs, (0, need - s)) if s < need else bufs[:, :need]
    return bufs.reshape(b, -1, front.hop_length)


def fused_log_mel_plain(audio_rows: torch.Tensor, front: FrontendConfig,
                        num_frames: int, *, fast_dft: bool = False) -> torch.Tensor:
    """The kernel's chain in torch fp32, in the Pallas body's segmented form:
    frame f covers rows f..f+n_seg-1, so the DFT is a sum of n_seg products.
    fast_dft: each segment's product is the three exact products of the bf16
    halves (upcast, fp32 sums), added in JAX's order hi·hi, hi·lo, lo·hi."""
    hop, win = front.hop_length, front.window_length
    c, mel = _device_matrices(front, audio_rows.device)
    nbp = _padded_matrices(front)[2]
    a = audio_rows.float()
    if fast_dft:
        c_hi, c_lo = (t.float() for t in _device_split_matrices(front, a.device))
        a_hi = a.to(torch.bfloat16).float()
        a_lo = (a - a_hi).to(torch.bfloat16).float()
    acc = 0.0
    for k in range(-(-win // hop)):
        lo, hi = k * hop, min((k + 1) * hop, win)
        seg = (slice(None), slice(k, num_frames + k), slice(0, hi - lo))
        if fast_dft:
            acc = acc + a_hi[seg] @ c_hi[lo:hi]
            acc = acc + a_hi[seg] @ c_lo[lo:hi]
            acc = acc + a_lo[seg] @ c_hi[lo:hi]
        else:
            acc = acc + a[seg] @ c[lo:hi]
    re, im = acc[..., :nbp], acc[..., nbp:]
    m = torch.sqrt(re * re + im * im) @ mel
    return torch.log(m + front.log_offset) * front.log_scale + front.log_bias


def fused_log_mel(audio_rows: torch.Tensor, front: FrontendConfig,
                  num_frames: int, *, fast_dft: bool = False) -> torch.Tensor:
    """(B, R, hop) fp32 rows → log-mel (B, num_frames, num_mels) fp32
    (csrc/log_mel.cu): K8, or K8′ with fast_dft.  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel or raises."""
    if kern._device_kind(audio_rows) == "cpu":
        return fused_log_mel_plain(audio_rows, front, num_frames, fast_dft=fast_dft)
    kern._need(audio_rows.dtype == torch.float32 and audio_rows.is_contiguous()
               and audio_rows.dim() == 3 and audio_rows.shape[2] == front.hop_length,
               "rows must be contiguous fp32 (B, R, hop)")
    b, rows, hop = audio_rows.shape
    kern._need(b > 0 and num_frames > 0 and rows >= audio_rows_for(num_frames, front),
               f"{rows} rows for {num_frames} frames")
    kern._need(front.num_mels == 128, f"num_mels {front.num_mels} (the kernel takes 128)")
    kern._need(hop % (8 if fast_dft else 4) == 0,
               f"hop {hop} (K8 takes a multiple of 4, K8′ of 8)")
    kern._need(audio_rows.data_ptr() % 16 == 0, "rows must start 16-byte aligned")
    nbp = _padded_matrices(front)[2]
    k_lo, k_hi, _, weights = mel_bin_tables(front)
    runs, w = _device_mel_tables(front, audio_rows.device)
    out = torch.empty(b, num_frames, front.num_mels, dtype=torch.float32,
                      device=audio_rows.device)
    tables = (runs.data_ptr(), w.data_ptr(), weights.shape[1], out.data_ptr(), b, rows, hop,
              front.window_length, num_frames, nbp, k_lo, k_hi, front.num_mels,
              float(front.log_offset), float(front.log_scale), float(front.log_bias))
    if fast_dft:
        c_hi, c_lo = _device_split_matrices(front, audio_rows.device)
        kern._launch("log_mel_fast", audio_rows.device, audio_rows.data_ptr(), c_hi.data_ptr(),
                     c_lo.data_ptr(), *tables)
    else:
        c = _device_matrices(front, audio_rows.device)[0]
        kern._launch("log_mel", audio_rows.device, audio_rows.data_ptr(), c.data_ptr(), *tables)
    return out


def patch_index_arrays(lens: torch.Tensor, front: FrontendConfig,
                       patch: PatchConfig) -> Dict[str, torch.Tensor]:
    """time/freq indices + mask for a batch from the true lengths alone
    (equal to patchify_spectrogram's integer outputs)."""
    tp, seq_len = patch.time_patch_size, patch.patches_seq_len
    f1 = front.num_mels // patch.freq_patch_size
    valid_frames = -(-lens.to(torch.int32) // front.hop_length)
    valid_patches = ((valid_frames // tp) * f1)[:, None]
    positions = torch.arange(seq_len, dtype=torch.int32, device=lens.device)[None, :]
    mask = (positions < valid_patches).to(torch.int32)
    inds = positions * mask
    return {"audio_time_inds": inds // f1, "audio_freq_inds": inds % f1, "audio_mask": mask}


def fused_batch_wav_to_patches(bufs: torch.Tensor, lens: torch.Tensor, front: FrontendConfig,
                               patch: PatchConfig, *,
                               fast_dft: bool = False) -> Dict[str, torch.Tensor]:
    """(B, samples) zero-padded buffers + (B,) lengths → the patch dict of
    `wav_to_patches`, with the log-mel from K8, or from K8′ with fast_dft
    where the JAX package runs its kernel (`fits_vmem`; elsewhere JAX takes
    its exact chain, and the port K8).  Patches stay fp32 (the encoder
    casts them, which equals casting before the patchify)."""
    num_frames = -(-bufs.shape[1] // front.hop_length)
    logmel = fused_log_mel(buffer_to_rows(bufs, num_frames, front), front, num_frames,
                           fast_dft=fast_dft and fits_vmem(num_frames, front))
    valid_frames = -(-lens.to(torch.int32) // front.hop_length)
    return patchify_spectrogram(logmel, valid_frames, patch)
