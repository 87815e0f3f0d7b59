// K8: the fused frontend — hop-major audio rows → windowed DFT → |X| → mel
// → log, with only the (B, F, num_mels) log-mel written to device memory.
//
// Replaces `fused_log_mel` with fast_dft=False
// (cacophony_tpu/frontend/fused.py:153, pallas_call at :185, kernel body
// `_kernel:118`).  Its numerics:
//   X   = frame @ C        C = the re|im DFT matrix with the periodic Hann
//                          window folded in, each half padded to nbp lanes
//                          (`_padded_matrices:52`); full fp32 products
//   mag = sqrt(re² + im²)  fp32
//   mel = mag @ M          M = the TF mel matrix, zero rows past the bins
//   out = log(mel + offset) · scale + bias
// Both products are fp32 FMAs: TF32 keeps 10 mantissa bits, and the log
// turns a small relative error of a small mel value into a large error of
// the log-mel.
//
// On the TPU one grid step held one clip's whole (R, hop) row block and the
// (F, 2·nbp) fp32 accumulator in VMEM, which is why a 30-s clip did not fit
// there.  Here a block takes TF frames of one clip: the audio they cover,
// (TF - 1)·hop + win contiguous samples, is copied once into shared memory,
// and every frame is a window into it (frame f starts at sample f·hop), so
// the overlapped framing is never materialised and no frame count is too
// long.  The spectrogram is produced BC bins at a time: a DFT tile of
// TF × BC complex values in registers, its magnitudes in shared memory, then
// their share of the mel product added to TF × 128 accumulators held in
// registers across the chunks.  Chunks past the last real bin are skipped:
// their DFT columns and mel rows are the zero padding, whose contribution is
// exactly 0.
//
// Bound on the card: fp32 FMA throughput.  A 10-s clip needs 1000 frames × 400
// samples × 2·320 DFT columns plus 1000 × 320 × 128 mel FMAs ≈ 0.3 GFMA;
// each thread keeps 4 × 4 complex DFT sums and 4 × 8 mel sums in registers,
// so one shared-memory value feeds 4 to 8 FMAs.
#include <cuda_runtime.h>

namespace k8 {

constexpr int TF = 64;       // frames per block
constexpr int BC = 64;       // spectrogram bins per chunk
constexpr int KT = 16;       // DFT depth staged in shared memory per step
constexpr int MELS = 128;    // mel channels (16 threads × 8)
constexpr int MG_LD = BC + 4;
constexpr int THREADS = 256;  // 16 × 16: ty picks 4 frames, tx 4 bins / 8 mels

__host__ __device__ constexpr int aud_floats(int hop, int win) {
  return (((TF - 1) * hop + win) + 3) & ~3;
}

__global__ void __launch_bounds__(THREADS)
    log_mel_kernel(const float* __restrict__ rows, const float* __restrict__ dft,
                   const float* __restrict__ mel, float* __restrict__ out, int R, int hop, int win,
                   int F, int nbp, int nbins, float log_offset, float log_scale, float log_bias) {
  extern __shared__ __align__(16) float smem[];
  float* aud = smem;                         // (TF - 1)·hop + win samples
  float* ct = aud + aud_floats(hop, win);    // [KT][2·BC]: re | im of this chunk
  float* mg = ct + KT * 2 * BC;              // [TF][MG_LD] magnitudes
  float* ml = mg + TF * MG_LD;               // [BC][MELS] mel rows

  const int b = blockIdx.y, f0 = blockIdx.x * TF;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* clip = rows + static_cast<size_t>(b) * R * hop + static_cast<size_t>(f0) * hop;
  const int aud_len = (TF - 1) * hop + win;
  const int avail = (R - f0) * hop;  // samples left in the clip's rows from frame f0
  for (int i = tid; i < aud_len; i += THREADS) aud[i] = i < avail ? clip[i] : 0.f;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nchunks = (nbins + BC - 1) / BC;
  for (int c = 0; c < nchunks; ++c) {
    const int k0 = c * BC;
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int n0 = 0; n0 < win; n0 += KT) {
      __syncthreads();  // the audio is in place; every thread is done with ct (and mg, ml)
      for (int e = tid; e < KT * 2 * BC; e += THREADS) {
        const int r = e / (2 * BC), col = e % (2 * BC), n = n0 + r;
        const int gcol = col < BC ? k0 + col : nbp + k0 + (col - BC);
        ct[e] = n < win ? dft[static_cast<size_t>(n) * 2 * nbp + gcol] : 0.f;
      }
      __syncthreads();
      const int kmax = min(KT, win - n0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = aud[(ty * 4 + i) * hop + n0 + kk];
        const float4 cr = *reinterpret_cast<const float4*>(&ct[kk * 2 * BC + tx * 4]);
        const float4 ci = *reinterpret_cast<const float4*>(&ct[kk * 2 * BC + BC + tx * 4]);
        const float crv[4] = {cr.x, cr.y, cr.z, cr.w};
        const float civ[4] = {ci.x, ci.y, ci.z, ci.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(a[i], crv[j], re[i][j]);
            im[i][j] = fmaf(a[i], civ[j], im[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mg[(ty * 4 + i) * MG_LD + tx * 4 + j] = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
    for (int e = tid; e < BC * MELS; e += THREADS) {
      const int k = k0 + e / MELS;
      ml[e] = k < nbp ? mel[static_cast<size_t>(k) * MELS + e % MELS] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < BC; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = mg[(ty * 4 + i) * MG_LD + k];
      const float4 m0 = *reinterpret_cast<const float4*>(&ml[k * MELS + tx * 8]);
      const float4 m1 = *reinterpret_cast<const float4*>(&ml[k * MELS + tx * 8 + 4]);
      const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], mv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty * 4 + i;
    if (f >= F) continue;
    float* orow = out + (static_cast<size_t>(b) * F + f) * MELS + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) orow[j] = logf(acc[i][j] + log_offset) * log_scale + log_bias;
  }
}

}  // namespace k8

// rows (B, R, hop) fp32; dft (win, 2·nbp) fp32; mel (nbp, M) fp32 → out (B, F, M) fp32.
extern "C" int k8_log_mel(const float* rows, const float* dft, const float* mel, float* out, int B,
                          int R, int hop, int win, int F, int nbp, int nbins, int M,
                          float log_offset, float log_scale, float log_bias, void* stream) {
  using namespace k8;
  if (B <= 0 || F <= 0 || hop <= 0 || win <= 0 || M != MELS || nbp % BC != 0 || nbins > nbp ||
      static_cast<long long>(R) * hop < static_cast<long long>(F - 1) * hop + win)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (aud_floats(hop, win) + KT * 2 * BC + TF * MG_LD + BC * MELS);
  cudaError_t err =
      cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + TF - 1) / TF, B);
  log_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, dft, mel, out, R, hop, win, F, nbp, nbins, log_offset, log_scale, log_bias);
  return static_cast<int>(cudaGetLastError());
}
