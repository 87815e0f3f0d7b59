// K8 and K8′: the fused frontend — hop-major audio rows → windowed DFT → |X|
// → mel → log, with only the (B, F, num_mels) log-mel written to device
// memory.  K8′ (log_mel_fast_kernel) is the same chain with the DFT as three
// bf16 tensor-core products.
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
// there.  Here a block takes XF = 64 frames of one clip: the audio they
// cover is copied once into shared memory and every frame is a window into
// it (frame f starts at sample f·hop), so the overlapped framing is never
// materialised and no frame count is too long.
//
// Only the work the log-mel needs (the host's `mel_bin_tables`):
//  - bins [k_lo, k_hi), those whose mel row has a nonzero (1–255 of 257 at
//    the default frontend: the DC row is zeroed and the top band edge is
//    Nyquist).  Every other bin adds mag·0 to every mel sum, exactly 0;
//  - per mel channel its run of nonzero bins and their weights (at most 2
//    nonzeros a bin, 505 of 257 × 128 at the default frontend).  Each
//    channel's sum runs over its run in ascending bin order with fmaf,
//    which is the dense ascending sum bit for bit (every term left out is
//    fmaf(mag, 0, acc) == acc).
//
// Both kernels share one skeleton: 512 threads, 16 warps as 2 frame halves
// × 8 bin groups of 32 bins; passes of up to XNB = 256 bins (one at the
// default frontend); the DFT matrix streamed through a cp.async ring, one
// barrier a stage; then the pass's magnitudes go to shared memory over the
// ring and each thread adds the pass's share of 16 (frame, channel) mel
// sums (x_mel_pass): the last pass writes the log-mel, an earlier one
// leaves the sum in the output for the next.  One block an SM.
//
// K8's bound on the card: fp32 FMA throughput (67 TFLOP/s): a 10-s clip
// needs 1000 frames × 400 samples × 2·255 columns of DFT FMAs; the mel
// stage is 1000 × 505.  Its DFT is a register-tiled SIMT product (gemm.cu's
// gemm_simt_kernel is the model):
//  - a thread holds 8 frames (fr + 4i) × 4 bins, re and im: 64 accumulators,
//    so a float4 of audio (4 samples of one frame) and two float4s of the
//    DFT stage (4 bins' re and im at one sample) feed 256 FMAs per 16 loads;
//  - the audio is stored as hop rows hop + 4 floats apart, so the four
//    frames a warp reads at once land 4 banks apart (one wavefront), and 4
//    samples never cross a row (4 divides hop);
//  - the ring holds XSTAGES stages of XKT window samples (re | im of the
//    pass's bins); the copy of stage s + 2 overlaps the FMAs of stage s.
#include "k1_common.cuh"

namespace k8 {

using k1::bf16;
using k1::cp_async16;

constexpr int MELS = 128;      // mel channels
constexpr int XF = 64;         // frames per block
constexpr int XNB = 256;       // bins per pass
constexpr int XCW = 2 * XNB;   // DFT columns of a stage row: re | im of the pass's bins
constexpr int XTHREADS = 512;  // 16 warps: 2 frame halves × 8 bin groups
constexpr int XMG_LD = XNB + 4;
constexpr int SMEM_MAX = 232448;  // a Hopper block's most shared memory

constexpr int XKT = 20;        // K8: window samples per stage (a 400-sample window: 20 stages)
constexpr int XSTAGES = 3;
static_assert(XKT % 4 == 0 && (XKT * XCW / 4) % XTHREADS == 0, "a stage is whole float4s per thread");
static_assert(XF * XMG_LD <= XSTAGES * XKT * XCW, "the magnitudes fit over the ring");

// Hop rows of audio a block needs: frames 0..XF-1, each window rounded up
// to whole stages of kt samples (the DFT rows past the window are zero).
__host__ __device__ inline int x_aud_rows(int hop, int win, int kt) {
  return ((XF - 1) * hop + (win + kt - 1) / kt * kt + hop - 1) / hop;
}

// Floats of the shared tail both kernels keep after their audio and ring:
// each channel's weights [MELS][wmax] and run [MELS][2] (int).
__host__ __device__ inline size_t x_tail_floats(int wmax) { return MELS * wmax + 2 * MELS; }

// The tables to shared memory by cp.async, committed with the first ring
// stage, so that no thread waits on them before its first product.
__device__ __forceinline__ void x_tables(float* ws, int* rl, const int* __restrict__ runs,
                                         const float* __restrict__ weights, int wmax) {
  for (int e = threadIdx.x; e < MELS * wmax; e += XTHREADS) k1::cp_async4(ws + e, weights + e, 4);
  for (int e = threadIdx.x; e < 2 * MELS; e += XTHREADS) k1::cp_async4(rl + e, runs + e, 4);
}

// The pass's share of each mel sum: channel m over its run's bins in this
// pass (bins p0..p0+XNB-1, magnitudes in mg), ascending, fp32 FMAs.  Thread
// t takes channel t % 128 of frames t / 128, + 4, + 8, ...; a sum waits in
// `out` from one pass to the next (each thread reads back only what it
// wrote), and the last pass writes log(sum + offset) · scale + bias.  The
// barrier before (mg written) and after (mg overwritten) are the caller's.
__device__ __forceinline__ void x_mel_pass(float* __restrict__ out, const float* mg, const float* ws,
                                           const int* rl, int wmax, int p0, bool first, bool last,
                                           int b, int f0, int F, float log_offset, float log_scale,
                                           float log_bias) {
  const int m = threadIdx.x & (MELS - 1), lo_m = rl[2 * m], hi_m = rl[2 * m + 1];
  const int lo = max(lo_m, p0), hi = min(hi_m, p0 + XNB - 1);
  for (int f = threadIdx.x / MELS; f < XF && f0 + f < F; f += XTHREADS / MELS) {
    float* o = out + (static_cast<size_t>(b) * F + f0 + f) * MELS + m;
    float acc = first ? 0.f : *o;
    for (int k = lo; k <= hi; ++k) acc = fmaf(mg[f * XMG_LD + k - p0], ws[m * wmax + k - lo_m], acc);
    *o = last ? logf(acc + log_offset) * log_scale + log_bias : acc;
  }
}

// Passes of XNB bins from p_start (a multiple of 8) over [k_lo, k_hi), at
// least one so that every output is written.
__device__ __forceinline__ int x_passes(int p_start, int k_hi) {
  return k_hi > p_start ? (k_hi - p_start + XNB - 1) / XNB : 1;
}

// ---------------------------------------------------------------------------
// K8 (exact fp32)

// Window samples n0..n0+XKT-1 of the pass's DFT columns into a ring stage:
// re of bins p0.. in columns 0..XNB-1, their im after; zeros past the window
// and past the padded bins.
__device__ __forceinline__ void x_load_stage(float* st, const float* __restrict__ dft, int n0, int win,
                                             int p0, int nbp) {
#pragma unroll
  for (int i = 0; i < XKT * XCW / 4 / XTHREADS; ++i) {
    const int e = threadIdx.x + i * XTHREADS;
    const int r = e / (XCW / 4), col = (e % (XCW / 4)) * 4, n = n0 + r;
    const int k = p0 + (col & (XNB - 1));
    const bool ok = n < win && k < nbp;
    const size_t src = static_cast<size_t>(n) * 2 * nbp + (col < XNB ? 0 : nbp) + k;
    cp_async16(st + r * XCW + col, dft + (ok ? src : 0), ok ? 16 : 0);
  }
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// HOP > 0 fixes the hop at compile time (the frame strides become
// immediate offsets); HOP == 0 takes it from hop_arg.
template <int HOP>
__global__ void __launch_bounds__(XTHREADS, 1)
    log_mel_kernel(const float* __restrict__ rows, const float* __restrict__ dft,
                   const int* __restrict__ runs, const float* __restrict__ weights, int wmax,
                   float* __restrict__ out, int R, int hop_arg, int win, int F, int nbp, int k_lo,
                   int k_hi, float log_offset, float log_scale, float log_bias) {
  const int hop = HOP > 0 ? HOP : hop_arg, ap = hop + 4;
  const int arows = x_aud_rows(hop, win, XKT);
  extern __shared__ __align__(16) float smem[];
  float* aud = smem;                         // [arows][ap] the block's audio
  float* ring = aud + arows * ap;            // [XSTAGES][XKT][XCW] DFT stages
  float* mg = ring;                          // [XF][XMG_LD] a pass's magnitudes, over the ring
  float* ws = ring + XSTAGES * XKT * XCW;    // [MELS][wmax] each channel's weights over its run
  int* rl = reinterpret_cast<int*>(ws + MELS * wmax);  // [MELS][2] each channel's run

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, f0 = blockIdx.x * XF;
  const int fr = (warp >> 3) * 32 + (lane >> 3);    // frames fr + 4i, i < 8
  const int bc = (warp & 7) * 32 + (lane & 7) * 4;  // the pass's bins bc..bc+3

  x_tables(ws, rl, runs, weights, wmax);
  // hop rows f0.. of clip b, zeros past its R rows; committed with stage 0
  const int h4 = hop / 4;
  for (int e = tid; e < arows * h4; e += XTHREADS) {
    const int r = e / h4, c = (e - r * h4) * 4;
    const bool ok = f0 + r < R;
    cp_async16(aud + r * ap + c, rows + (ok ? (static_cast<size_t>(b) * R + f0 + r) * hop + c : 0),
               ok ? 16 : 0);
  }

  const int nst = (win + XKT - 1) / XKT, p_start = k_lo & ~7, npass = x_passes(p_start, k_hi);
  for (int pass = 0; pass < npass; ++pass) {
    const int p0 = p_start + pass * XNB;
#pragma unroll
    for (int s = 0; s < XSTAGES - 1; ++s) {
      if (s < nst) x_load_stage(ring + s * XKT * XCW, dft, s * XKT, win, p0, nbp);
      k1::cp_async_commit();
    }
    float re[8][4], im[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int s = 0; s < nst; ++s) {
      k1::cp_async_wait<XSTAGES - 2>();  // stage s (and the audio) landed for this thread
      __syncthreads();                   // … for every thread; stage s - 1 is consumed
      const int next = s + XSTAGES - 1;
      if (next < nst) x_load_stage(ring + (next % XSTAGES) * XKT * XCW, dft, next * XKT, win, p0, nbp);
      k1::cp_async_commit();
      const float* st = ring + (s % XSTAGES) * XKT * XCW + bc;
      int ar = s * XKT / hop, ac = s * XKT - ar * hop;  // the stage's first sample: hop row, column
#pragma unroll
      for (int q = 0; q < XKT / 4; ++q) {
        const float* arow = aud + (fr + ar) * ap + ac;  // 4 samples in one row: 4 divides hop
        ac += 4;
        if (ac == hop) ac = 0, ++ar;
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(arow + 4 * i * ap);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 cr = *reinterpret_cast<const float4*>(st + (4 * q + kk) * XCW);
          const float4 ci = *reinterpret_cast<const float4*>(st + (4 * q + kk) * XCW + XNB);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float x = f4(a[i], kk);
            re[i][0] = fmaf(x, cr.x, re[i][0]);
            re[i][1] = fmaf(x, cr.y, re[i][1]);
            re[i][2] = fmaf(x, cr.z, re[i][2]);
            re[i][3] = fmaf(x, cr.w, re[i][3]);
            im[i][0] = fmaf(x, ci.x, im[i][0]);
            im[i][1] = fmaf(x, ci.y, im[i][1]);
            im[i][2] = fmaf(x, ci.z, im[i][2]);
            im[i][3] = fmaf(x, ci.w, im[i][3]);
          }
        }
      }
    }
    k1::cp_async_wait<0>();
    __syncthreads();  // every thread is done with the ring: the magnitudes go over it
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float4 v;
      v.x = sqrtf(re[i][0] * re[i][0] + im[i][0] * im[i][0]);
      v.y = sqrtf(re[i][1] * re[i][1] + im[i][1] * im[i][1]);
      v.z = sqrtf(re[i][2] * re[i][2] + im[i][2] * im[i][2]);
      v.w = sqrtf(re[i][3] * re[i][3] + im[i][3] * im[i][3]);
      *reinterpret_cast<float4*>(mg + (fr + 4 * i) * XMG_LD + bc) = v;
    }
    __syncthreads();
    x_mel_pass(out, mg, ws, rl, wmax, p0, pass == 0, pass == npass - 1, b, f0, F, log_offset,
               log_scale, log_bias);
    __syncthreads();  // the next pass's stages may go over the magnitudes
  }
}

// ---------------------------------------------------------------------------
// K8′: replaces `fused_log_mel` with fast_dft=True (the same pallas_call,
// the branch at fused.py:135-141).  The DFT runs as three bf16 products
// with fp32 accumulation, hi·hi + hi·lo + lo·hi, in that order per k-step:
//   audio: hi = bf16(x), lo = bf16(x − f32(hi)), both rounded to nearest
//          even, split once per sample as it is staged in shared memory;
//   matrix: the same split of the re|im DFT matrix, made once on the host
//          (`_split_bf16`, fused.py:69-73) and kept on the device.
// The lo·lo term is dropped (about 16 mantissa bits).  Magnitude, mel stage
// and log are K8's (fp32).
//
// Bound on the card: a 10-s clip needs 3 × 1000 × 400 × 510 bf16 MACs at
// the tensor-core rate (989 TFLOP/s) and K8's 1000 × 505 fp32 mel FMAs.
// The three products run on the tensor cores through mma.sync m16n8k16
// (bf16 in, fp32 accumulate) with k1_common.cuh's fragment helpers, on K8's
// skeleton:
//  - a warp holds 32 frames (two m-tiles) × 32 bins, re and im (8 n-tiles):
//    a thread's accumulators hold the re and im of the same bins, so the
//    magnitude is taken in registers;
//  - A comes by ldmatrix from the block's audio, split hi | lo into bf16
//    hop rows hop + 8 elements apart (336 bytes at hop 160), so the 8
//    frames of one ldmatrix phase land on distinct banks; a frame's 8
//    samples never cross a row (8 divides hop), so the overlapped frames
//    need no copy of their own;
//  - B (the hi and lo DFT matrices) streams through a ring of FSTAGES
//    stages of FKT samples by cp.async, rows 16 bytes longer than the
//    columns so that ldmatrix.trans reads them without conflicts.
constexpr int FKT = 16;              // K8′: window samples per stage (one k-step)
constexpr int FSTAGES = 4;
constexpr int CT_LD = XCW + 8;       // a stage row: re | im of the pass's bins, +16 bytes
static_assert((2 * FKT * XCW / 8) % XTHREADS == 0, "a stage is whole 16-byte pieces per thread");
static_assert(sizeof(float) * XF * XMG_LD <= sizeof(bf16) * FSTAGES * 2 * FKT * CT_LD,
              "the magnitudes fit over the ring");

__host__ __device__ inline size_t log_mel_fast_smem(int hop, int win, int wmax) {
  return sizeof(bf16) * (2 * static_cast<size_t>(x_aud_rows(hop, win, FKT)) * (hop + 8) +
                         FSTAGES * 2 * FKT * CT_LD) +
         sizeof(float) * x_tail_floats(wmax);
}

// Window samples n0..n0+FKT-1 of the pass's hi and lo DFT columns into a
// ring stage ([hi | lo][FKT][CT_LD]); zeros past the window and the bins.
__device__ __forceinline__ void f_load_stage(bf16* st, const bf16* __restrict__ c_hi,
                                             const bf16* __restrict__ c_lo, int n0, int win, int p0,
                                             int nbp) {
#pragma unroll
  for (int i = 0; i < 2 * FKT * XCW / 8 / XTHREADS; ++i) {
    const int e = threadIdx.x + i * XTHREADS;
    const int half = e / (FKT * XCW / 8), r = (e / (XCW / 8)) % FKT, col = (e % (XCW / 8)) * 8;
    const int n = n0 + r, k = p0 + (col & (XNB - 1));
    const bool ok = n < win && k < nbp;
    const size_t src = static_cast<size_t>(n) * 2 * nbp + (col < XNB ? 0 : nbp) + k;
    cp_async16(st + (half * FKT + r) * CT_LD + col, (half ? c_lo : c_hi) + (ok ? src : 0), ok ? 16 : 0);
  }
}

template <int HOP>
__global__ void __launch_bounds__(XTHREADS, 1)
    log_mel_fast_kernel(const float* __restrict__ rows, const bf16* __restrict__ c_hi,
                        const bf16* __restrict__ c_lo, const int* __restrict__ runs,
                        const float* __restrict__ weights, int wmax, float* __restrict__ out, int R,
                        int hop_arg, int win, int F, int nbp, int k_lo, int k_hi, float log_offset,
                        float log_scale, float log_bias) {
  const int hop = HOP > 0 ? HOP : hop_arg, ap = hop + 8;
  const int arows = x_aud_rows(hop, win, FKT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* aud_hi = reinterpret_cast<bf16*>(smem_raw);  // [arows][ap] the block's audio, split
  bf16* aud_lo = aud_hi + arows * ap;
  bf16* ring = aud_lo + arows * ap;                   // [FSTAGES][hi | lo][FKT][CT_LD]
  float* mg = reinterpret_cast<float*>(ring);         // [XF][XMG_LD] magnitudes, over the ring
  float* ws = reinterpret_cast<float*>(ring + FSTAGES * 2 * FKT * CT_LD);  // [MELS][wmax]
  int* rl = reinterpret_cast<int*>(ws + MELS * wmax);                     // [MELS][2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, f0 = blockIdx.x * XF;
  const int wf = (warp >> 3) * 32, wb = (warp & 7) * 32;  // the warp's frames and bins

  x_tables(ws, rl, runs, weights, wmax);
  // hop rows f0.. of clip b (zeros past its R rows), split into bf16 hi | lo
  const int h4 = hop / 4;
  for (int e = tid; e < arows * h4; e += XTHREADS) {
    const int r = e / h4, c = (e - r * h4) * 4;
    const float4 v = f0 + r < R
        ? *reinterpret_cast<const float4*>(rows + (static_cast<size_t>(b) * R + f0 + r) * hop + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf16 hi = __float2bfloat16_rn(x[j]);
      aud_hi[r * ap + c + j] = hi;
      aud_lo[r * ap + c + j] = __float2bfloat16_rn(x[j] - __bfloat162float(hi));
    }
  }

  // this lane's ldmatrix row of the A fragments: frame wf + (lane & 15)
  // (+16 for the second m-tile), samples + (lane >> 4)·8 of the k-step
  const int a_frame = wf + (lane & 15), a_off = (lane >> 4) * 8;
  const int nst = (win + FKT - 1) / FKT, p_start = k_lo & ~7, npass = x_passes(p_start, k_hi);
  for (int pass = 0; pass < npass; ++pass) {
    const int p0 = p_start + pass * XNB;
#pragma unroll
    for (int s = 0; s < FSTAGES - 1; ++s) {
      if (s < nst) f_load_stage(ring + s * 2 * FKT * CT_LD, c_hi, c_lo, s * FKT, win, p0, nbp);
      k1::cp_async_commit();
    }
    float acc[2][8][4];  // [m-tile][n-tile: re of bins wb + 8j for j < 4, their im for j ≥ 4][4]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int s = 0; s < nst; ++s) {
      k1::cp_async_wait<FSTAGES - 2>();
      __syncthreads();
      const int next = s + FSTAGES - 1;
      if (next < nst)
        f_load_stage(ring + (next % FSTAGES) * 2 * FKT * CT_LD, c_hi, c_lo, next * FKT, win, p0, nbp);
      k1::cp_async_commit();
      const bf16* st = ring + (s % FSTAGES) * 2 * FKT * CT_LD;
      int ar = (s * FKT + a_off) / hop, ac = s * FKT + a_off - ar * hop;  // this lane's hop row, column
#pragma unroll
      for (int kk = 0; kk < FKT; kk += 16) {
        const int a_idx = (a_frame + ar) * ap + ac;  // 8 samples in one row: 8 divides hop
        for (ac += 16; ac >= hop; ac -= hop) ++ar;
        unsigned ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          k1::ldmatrix_x4(ah[i], aud_hi + a_idx + i * 16 * ap);
          k1::ldmatrix_x4(al[i], aud_lo + a_idx + i * 16 * ap);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // q < 2: re of 16 bins, else their im
          const int col = (q >> 1) * XNB + wb + (q & 1) * 16;
          unsigned bh[4], bl[4];
          k1::frag_b_kn(bh, st, CT_LD, kk, col);
          k1::frag_b_kn(bl, st + FKT * CT_LD, CT_LD, kk, col);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float(&d)[4] = acc[i][q * 2 + h];
              k1::mma_bf16(d, ah[i], bh[2 * h], bh[2 * h + 1]);
              k1::mma_bf16(d, ah[i], bl[2 * h], bl[2 * h + 1]);
              k1::mma_bf16(d, al[i], bh[2 * h], bh[2 * h + 1]);
            }
        }
      }
    }
    k1::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: the magnitudes go over it
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          float2 v;
          v.x = sqrtf(acc[i][j][e] * acc[i][j][e] + acc[i][4 + j][e] * acc[i][4 + j][e]);
          v.y = sqrtf(acc[i][j][e + 1] * acc[i][j][e + 1] + acc[i][4 + j][e + 1] * acc[i][4 + j][e + 1]);
          *reinterpret_cast<float2*>(mg + (wf + i * 16 + g + (e >> 1) * 8) * XMG_LD + wb + j * 8 + 2 * t) = v;
        }
    __syncthreads();
    x_mel_pass(out, mg, ws, rl, wmax, p0, pass == 0, pass == npass - 1, b, f0, F, log_offset,
               log_scale, log_bias);
    __syncthreads();
  }
}

// What both entry points refuse: → true if the kernels take these shapes.
inline bool takes(int B, int R, int hop, int win, int F, int nbp, int k_lo, int k_hi, int M, int wmax,
                  const void* rows) {
  return B > 0 && F > 0 && hop > 0 && win > 0 && M == MELS && nbp % 8 == 0 && k_lo >= 0 &&
         k_hi <= nbp && wmax > 0 && (reinterpret_cast<uintptr_t>(rows) & 15) == 0 &&
         static_cast<long long>(R) * hop >= static_cast<long long>(F - 1) * hop + win;
}

template <typename K, typename... Args>
int launch(K kernel, size_t smem, int F, int B, void* stream, Args... args) {
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + XF - 1) / XF, B);
  kernel<<<grid, XTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k8

// rows (B, R, hop) fp32; dft (win, 2·nbp) fp32; runs (M, 2) int32 and
// weights (M, wmax) fp32 from `mel_bin_tables`; bins [k_lo, k_hi) →
// out (B, F, M) fp32.  hop a multiple of 4.
extern "C" int k8_log_mel(const float* rows, const float* dft, const int* runs, const float* weights,
                          int wmax, float* out, int B, int R, int hop, int win, int F, int nbp,
                          int k_lo, int k_hi, int M, float log_offset, float log_scale,
                          float log_bias, void* stream) {
  using namespace k8;
  if (!takes(B, R, hop, win, F, nbp, k_lo, k_hi, M, wmax, rows) || hop % 4 ||
      (reinterpret_cast<uintptr_t>(dft) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (static_cast<size_t>(x_aud_rows(hop, win, XKT)) * (hop + 4) +
                                       XSTAGES * XKT * XCW + x_tail_floats(wmax));
  return launch(hop == 160 ? log_mel_kernel<160> : log_mel_kernel<0>, smem, F, B, stream, rows, dft,
                runs, weights, wmax, out, R, hop, win, F, nbp, k_lo, k_hi, log_offset, log_scale,
                log_bias);
}

// rows (B, R, hop) fp32; c_hi, c_lo (win, 2·nbp) bf16; runs, weights, bins
// as k8_log_mel → out (B, F, M) fp32.  hop a multiple of 8.
extern "C" int k8_log_mel_fast(const float* rows, const void* c_hi, const void* c_lo,
                               const int* runs, const float* weights, int wmax, float* out, int B,
                               int R, int hop, int win, int F, int nbp, int k_lo, int k_hi, int M,
                               float log_offset, float log_scale, float log_bias, void* stream) {
  using namespace k8;
  if (!takes(B, R, hop, win, F, nbp, k_lo, k_hi, M, wmax, rows) || hop % 8 ||
      ((reinterpret_cast<uintptr_t>(c_hi) | reinterpret_cast<uintptr_t>(c_lo)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(hop == 160 ? log_mel_fast_kernel<160> : log_mel_fast_kernel<0>,
                log_mel_fast_smem(hop, win, wmax), F, B, stream, rows,
                static_cast<const bf16*>(c_hi), static_cast<const bf16*>(c_lo), runs, weights, wmax,
                out, R, hop, win, F, nbp, k_lo, k_hi, log_offset, log_scale, log_bias);
}
