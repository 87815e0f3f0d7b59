// K8 and K8′: the fused frontend — hop-major audio rows → windowed DFT → |X|
// → mel → log, with only the (B, F, num_mels) log-mel written to device
// memory.  K8′ (log_mel_fast_kernel, at the end of this file) is the same
// chain with the DFT as three bf16 tensor-core products.
//
// K8 replaces `fused_log_mel` with fast_dft=False
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
#include "k1_common.cuh"

namespace k8 {

using k1::bf16;

constexpr int TF = 64;       // frames per block
constexpr int BC = 64;       // spectrogram bins per chunk
constexpr int KT = 16;       // DFT depth staged in shared memory per step
constexpr int MELS = 128;    // mel channels (16 threads × 8)
constexpr int MG_LD = BC + 4;
constexpr int THREADS = 256;  // 16 × 16: ty picks 4 frames, tx 4 bins / 8 mels

__host__ __device__ constexpr int aud_floats(int hop, int win) {
  return (((TF - 1) * hop + win) + 3) & ~3;
}

// The chunk's magnitudes are in mg (TF frames × BC bins); stage its BC mel
// rows in ml and add their share of the mel product to acc (fp32 FMAs;
// thread (tx, ty) holds frames ty·4.. and mel channels tx·8..).
__device__ __forceinline__ void add_mel_chunk(float (&acc)[4][8], const float* mg, float* ml,
                                              const float* __restrict__ mel, int k0, int nbp) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
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

__device__ __forceinline__ void store_log_mel(const float (&acc)[4][8], float* __restrict__ out,
                                              int b, int f0, int F, float log_offset,
                                              float log_scale, float log_bias) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty * 4 + i;
    if (f >= F) continue;
    float* orow = out + (static_cast<size_t>(b) * F + f) * MELS + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) orow[j] = logf(acc[i][j] + log_offset) * log_scale + log_bias;
  }
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
    add_mel_chunk(acc, mg, ml, mel, k0, nbp);
  }
  store_log_mel(acc, out, b, f0, F, log_offset, log_scale, log_bias);
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

namespace k8 {

// ---------------------------------------------------------------------------
// K8′: replaces `fused_log_mel` with fast_dft=True (the same pallas_call,
// the branch at fused.py:135-141).  The DFT runs as three bf16 products
// with fp32 accumulation, hi·hi + hi·lo + lo·hi:
//   audio: hi = bf16(x), lo = bf16(x − f32(hi)), both rounded to nearest
//          even, split once per sample as it is staged in shared memory;
//   matrix: the same split of the re|im DFT matrix, made once on the host
//          (`_split_bf16`, fused.py:69-73) and kept on the device.
// The lo·lo term is dropped (about 16 mantissa bits).  Magnitude, mel
// product and log are K8's (add_mel_chunk, store_log_mel: fp32 FMAs).
//
// On Hopper the three products run on the tensor cores through mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), with k1_common.cuh's fragment
// helpers.  The frames stay windows into one shared-memory copy of their
// audio, as in K8: frame f's A row starts at sample f·hop, so ldmatrix reads
// the overlapped frames without materialising them (hop must be a multiple
// of 8 for 16-byte rows).  A block takes TF = 64 frames of one clip and the
// spectrogram BC = 64 bins at a time: eight warps, each 16 frames × 32 bins
// of re and of im, so that a thread holds the re and im of the same bins and
// takes their magnitude in registers.  The DFT matrix halves stream through
// shared memory KF = 80 window samples (five k-steps) at a time; the 400
// samples of the window are 25 k-steps.  The mel rows reuse that space once
// a chunk's DFT is done.
//
// Bound on the card: a 10-s clip needs 3 × 1000 × 400 × 640 bf16 MACs
// (≈ 0.77 G, 3× K8's DFT, at the tensor-core rate) and K8's 0.04 G fp32 mel
// FMAs, so the mel product and the shared-memory traffic bound it, not the
// DFT; the design keeps the DFT off the fp32 pipes.
constexpr int KF = 80;               // window samples per shared-memory stage
constexpr int CT_LD = 2 * BC + 8;    // a DFT stage row: re | im of the chunk, +16 bytes

__host__ __device__ constexpr int aud_fast_elems(int hop, int win) {
  return (((TF - 1) * hop + (win + KF - 1) / KF * KF) + 7) & ~7;
}

__host__ __device__ constexpr size_t log_mel_fast_smem(int hop, int win) {
  return sizeof(bf16) * (2 * aud_fast_elems(hop, win) + 2 * KF * CT_LD) +
         sizeof(float) * TF * MG_LD;
}

static_assert(sizeof(float) * BC * MELS <= sizeof(bf16) * 2 * KF * CT_LD,
              "the mel rows reuse the DFT stage's shared memory");

__global__ void __launch_bounds__(THREADS)
    log_mel_fast_kernel(const float* __restrict__ rows, const bf16* __restrict__ c_hi,
                        const bf16* __restrict__ c_lo, const float* __restrict__ mel,
                        float* __restrict__ out, int R, int hop, int win, int F, int nbp,
                        int nbins, float log_offset, float log_scale, float log_bias) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int a_n = aud_fast_elems(hop, win);
  bf16* aud_hi = reinterpret_cast<bf16*>(smem_raw);  // the block's audio, split
  bf16* aud_lo = aud_hi + a_n;
  bf16* ct_hi = aud_lo + a_n;                         // [KF][CT_LD] DFT stage, hi and lo
  bf16* ct_lo = ct_hi + KF * CT_LD;
  float* ml = reinterpret_cast<float*>(ct_hi);        // [BC][MELS] mel rows, after the DFT
  float* mg = reinterpret_cast<float*>(ct_lo + KF * CT_LD);  // [TF][MG_LD] magnitudes

  const int b = blockIdx.y, f0 = blockIdx.x * TF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // frames wm·16.., bins wn·32.. of the chunk
  const float* clip = rows + static_cast<size_t>(b) * R * hop + static_cast<size_t>(f0) * hop;
  const int avail = (R - f0) * hop;
  for (int i = tid; i < a_n; i += THREADS) {
    const float v = i < avail ? clip[i] : 0.f;
    const bf16 hi = __float2bfloat16_rn(v);
    aud_hi[i] = hi;
    aud_lo[i] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nchunks = (nbins + BC - 1) / BC;
  for (int c = 0; c < nchunks; ++c) {
    const int k0 = c * BC;
    float dft[8][4];  // n-tile j < 4: re of bins wn·32 + 8j..; j ≥ 4: their im
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dft[j][e] = 0.f;

    for (int n0 = 0; n0 < win; n0 += KF) {
      __syncthreads();  // the audio is in place; every warp is done with ct / ml and mg
      for (int e = tid; e < 2 * KF * (2 * BC / 8); e += THREADS) {
        const int half = e / (KF * 2 * BC / 8), r = (e / (2 * BC / 8)) % KF;
        const int col = (e % (2 * BC / 8)) * 8, n = n0 + r;
        const int gcol = col < BC ? k0 + col : nbp + k0 + (col - BC);
        const bf16* src = (half ? c_lo : c_hi) + static_cast<size_t>(n) * 2 * nbp + gcol;
        *reinterpret_cast<uint4*>((half ? ct_lo : ct_hi) + r * CT_LD + col) =
            k1::load8(src, n < win);  // rows past the window are 0: they add nothing
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KF; kk += 16) {
        unsigned ah[4], al[4];
        k1::frag_a(ah, aud_hi, hop, wm * 16, n0 + kk);
        k1::frag_a(al, aud_lo, hop, wm * 16, n0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // q < 2: re bins, else im bins; 16 columns each
          const int col = (q >> 1) * BC + wn * 32 + (q & 1) * 16;
          unsigned bh[4], bl[4];
          k1::frag_b_kn(bh, ct_hi, CT_LD, kk, col);
          k1::frag_b_kn(bl, ct_lo, CT_LD, kk, col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float(&d)[4] = dft[(q >> 1) * 4 + (q & 1) * 2 + h];
            k1::mma_bf16(d, ah, bh[2 * h], bh[2 * h + 1]);
            k1::mma_bf16(d, ah, bl[2 * h], bl[2 * h + 1]);
            k1::mma_bf16(d, al, bh[2 * h], bh[2 * h + 1]);
          }
        }
      }
    }

    __syncthreads();  // every warp is done with ct before the mel rows overwrite it
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mg[(wm * 16 + g + (e >> 1) * 8) * MG_LD + wn * 32 + j * 8 + 2 * t + (e & 1)] =
            sqrtf(dft[j][e] * dft[j][e] + dft[4 + j][e] * dft[4 + j][e]);
    add_mel_chunk(acc, mg, ml, mel, k0, nbp);
  }
  store_log_mel(acc, out, b, f0, F, log_offset, log_scale, log_bias);
}

}  // namespace k8

// rows (B, R, hop) fp32; c_hi, c_lo (win, 2·nbp) bf16; mel (nbp, M) fp32 → out (B, F, M) fp32.
extern "C" int k8_log_mel_fast(const float* rows, const void* c_hi, const void* c_lo,
                               const float* mel, float* out, int B, int R, int hop, int win, int F,
                               int nbp, int nbins, int M, float log_offset, float log_scale,
                               float log_bias, void* stream) {
  using namespace k8;
  if (B <= 0 || F <= 0 || hop <= 0 || hop % 8 || win <= 0 || M != MELS || nbp % BC != 0 ||
      nbins > nbp || static_cast<long long>(R) * hop < static_cast<long long>(F - 1) * hop + win)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = log_mel_fast_smem(hop, win);
  cudaError_t err =
      cudaFuncSetAttribute(log_mel_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + TF - 1) / TF, B);
  log_mel_fast_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, static_cast<const bf16*>(c_hi), static_cast<const bf16*>(c_lo), mel, out, R, hop, win,
      F, nbp, nbins, log_offset, log_scale, log_bias);
  return static_cast<int>(cudaGetLastError());
}
