// Masked multi-head attention: K1's attention part, and K4 / K5.
//
// Replaces the attention core of `_fused_block_kernel`
// (cacophony_tpu/ops/encoder_attention.py:553-555 → `_attend_oproj`,
// `_head_logits:164`, `_softmax_from_logits:175`, `_attend_from_logits:201`),
// and the one-shot and q-blocked attention kernels K4 (`_pallas_forward:317`,
// kernel `_kernel:277`) and K5 (`_pallas_forward_blocked:351`, kernel
// `_kernel_blocked:295`), which compute the same function.  It keeps their
// numerics, which are not those of a textbook softmax:
//   - q is scaled by 1/sqrt(Dh) in the compute dtype before Q·Kᵀ;
//   - logits are fp32 and clamped by one per-key bias: min(l, 80) for valid
//     keys, min(l, -1e30) for padded ones (and, with `causal`, for keys
//     after the query: `_softmax_kbias_causal:149`); the softmax is
//     max-free, p = exp(clamped logit), so no running-max rescale is needed;
//   - the row sum is taken over the fp32 p and floored at 1e-37; P·V uses p
//     cast to the compute dtype;
//   - V is pre-scaled by the exact power of two 2^-24 (no overflow of the
//     fp32 accumulator against p <= e^80), and the output is
//     (o / rowsum) * 2^24, in that order, so a fully masked row gives 0.
// Q, K and V are read from base pointers with row strides: the fused
// (B, S, 3D) QKV of K1 and K4 (strides 3D), or K5's separate Q (B, S, D)
// and K|V (B, S, 2D).  Head outputs are written side by side into a
// contiguous (B, S, D).
//
// Flash-style: one block per (q tile, head, batch row); K and V stream
// through shared memory in tiles of 64 keys; the (S, S) logits never leave
// registers.  On the TPU one grid step held the whole (S, S) fp32 tile in
// VMEM (1 MB at S = 496); an H100 block has 227 KB of shared memory, so
// K5's "K|V resident per row, Q per q-block" needs nothing more here.
// bf16: mma.sync m16n8k16; four warps of 16 query rows; P goes from the
// Q·Kᵀ accumulators straight into the A fragments of P·V.
// fp32: a plain shared-memory loop (one lane per key for the logits, one
// lane per output column for P·V); full fp32 has no tensor-core path.
// Causal: key tiles past the q tile's last row are skipped (their p is 0).
//
// Bound on the card: at S = 496, Dh = 96 the bf16 kernel does ~4·S·Dh
// flops per loaded K/V element per q tile (compute bound on mma.sync issue
// and the exp per logit); K/V tiles are re-read by each q tile of a row,
// from L2.
#include "k1_common.cuh"

namespace k1 {

constexpr int AQ = 64;  // query rows per block (4 warps x 16)
constexpr int AK = 64;  // keys per tile
constexpr int ATT_THREADS = 128;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  size_t q_row, kv_row;  // row strides, in elements
  const int* mask;       // (B, S), > 0 = valid key
  void* out;             // (B, S, H·HD)
  int S, H;
  float q_scale;
  int causal;
};

template <int HD>
__global__ void __launch_bounds__(ATT_THREADS) attention_bf16_kernel(AttnArgs a) {
  constexpr int LD = HD + 8;  // padded rows: conflict-free ldmatrix
  constexpr int CH = HD / 8;  // 16-byte chunks per head row
  __shared__ __align__(16) bf16 Qs[AQ * LD];
  __shared__ __align__(16) bf16 Ks[AK * LD];
  __shared__ __align__(16) bf16 Vs[AK * LD];
  __shared__ float kbias[AK];

  const int S = a.S, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AQ;
  const size_t row0 = static_cast<size_t>(b) * S;
  const bf16* qb = static_cast<const bf16*>(a.q) + row0 * a.q_row + h * HD;
  const bf16* kb = static_cast<const bf16*>(a.k) + row0 * a.kv_row + h * HD;
  const bf16* vb = static_cast<const bf16*>(a.v) + row0 * a.kv_row + h * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // Q tile, scaled in the compute dtype; rows past S are zero and never stored.
  for (int c = tid; c < AQ * CH; c += ATT_THREADS) {
    const int r = c / CH, ch = c % CH, s = q0 + r;
    uint4 v = load8(qb + s * a.q_row + ch * 8, s < S);
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * a.q_scale);
    *reinterpret_cast<uint4*>(&Qs[r * LD + ch * 8]) = v;
  }
  __syncthreads();

  unsigned qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) frag_a(qf[kk], Qs, LD, warp * 16, kk * 16);

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float rowsum[2] = {0.f, 0.f};  // rows g and g + 8 of this warp
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int k_end = a.causal ? min(S, q0 + AQ) : S;

  for (int k0 = 0; k0 < k_end; k0 += AK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < AK * CH; c += ATT_THREADS) {
      const int r = c / CH, ch = c % CH, s = k0 + r;
      uint4 kv = load8(kb + s * a.kv_row + ch * 8, s < S);
      uint4 vv = load8(vb + s * a.kv_row + ch * 8, s < S);
      bf16* e = reinterpret_cast<bf16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * VSCALE);
      *reinterpret_cast<uint4*>(&Ks[r * LD + ch * 8]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r * LD + ch * 8]) = vv;
    }
    for (int j = tid; j < AK; j += ATT_THREADS) {
      const int s = k0 + j;
      kbias[j] = (s < S && a.mask[row0 + s] > 0) ? SOFTMAX_CLAMP : NEG_INF;
    }
    __syncthreads();

    // logits: 16 query rows x 64 keys per warp, fp32 accumulators
    float sc[AK / 8][4];
#pragma unroll
    for (int n = 0; n < AK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < AK / 16; ++nj) {
        unsigned kf[4];
        frag_b_nk(kf, Ks, LD, nj * 16, kk * 16);
        mma_bf16(sc[2 * nj], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[2 * nj + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // clamp + exp in fp32; the accumulators become P·V's A fragments
#pragma unroll
    for (int n = 0; n < AK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        float kbv = kbias[c];
        if (a.causal && k0 + c > row[e >> 1]) kbv = NEG_INF;
        sc[n][e] = expf(fminf(sc[n][e], kbv));
        rowsum[e >> 1] += sc[n][e];
      }
    }
    unsigned pf[AK / 16][4];
    acc_to_a<AK / 8>(pf, sc);

    // o += P (16 x 64) · V (64 x HD)
#pragma unroll
    for (int kk = 0; kk < AK / 16; ++kk) {
#pragma unroll
      for (int dj = 0; dj < HD / 16; ++dj) {
        unsigned vf[4];
        frag_b_kn(vf, Vs, LD, kk * 16, dj * 16);
        mma_bf16(o[2 * dj], pf[kk], vf[0], vf[1]);
        mma_bf16(o[2 * dj + 1], pf[kk], vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 1);
    rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 2);
    rowsum[i] = fmaxf(rowsum[i], ROWSUM_FLOOR);
  }
  const int D = a.H * HD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row[half];
    if (s >= S) continue;
    bf16* orow = static_cast<bf16*>(a.out) + (row0 + s) * D + h * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float v0 = (o[n][half * 2] / rowsum[half]) * INV_VSCALE;
      const float v1 = (o[n][half * 2 + 1] / rowsum[half]) * INV_VSCALE;
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

constexpr int FQ = 32;      // query rows per block (4 warps x 8)
constexpr int FK = 32;      // keys per tile: one per lane
constexpr int F_HDMAX = 96;  // 36.5 KB of static shared memory

__global__ void __launch_bounds__(ATT_THREADS) attention_f32_kernel(AttnArgs a, int HD) {
  __shared__ float Qs[FQ][F_HDMAX];
  __shared__ float Ks[FK][F_HDMAX + 1];  // +1: lanes read distinct banks
  __shared__ float Vs[FK][F_HDMAX];
  __shared__ float kbias[FK];

  const int S = a.S, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const size_t row0 = static_cast<size_t>(b) * S;
  const float* qb = static_cast<const float*>(a.q) + row0 * a.q_row + h * HD;
  const float* kb = static_cast<const float*>(a.k) + row0 * a.kv_row + h * HD;
  const float* vb = static_cast<const float*>(a.v) + row0 * a.kv_row + h * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int c = tid; c < FQ * HD; c += ATT_THREADS) {
    const int r = c / HD, d = c % HD, s = q0 + r;
    Qs[r][d] = s < S ? qb[s * a.q_row + d] * a.q_scale : 0.f;
  }

  float o[8][F_HDMAX / 32];
  float rowsum[8];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    rowsum[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < F_HDMAX / 32; ++i) o[rr][i] = 0.f;
  }
  const int k_end = a.causal ? min(S, q0 + FQ) : S;

  for (int k0 = 0; k0 < k_end; k0 += FK) {
    __syncthreads();
    for (int c = tid; c < FK * HD; c += ATT_THREADS) {
      const int r = c / HD, d = c % HD, s = k0 + r;
      Ks[r][d] = s < S ? kb[s * a.kv_row + d] : 0.f;
      Vs[r][d] = s < S ? vb[s * a.kv_row + d] * VSCALE : 0.f;
    }
    if (tid < FK) {
      const int s = k0 + tid;
      kbias[tid] = (s < S && a.mask[row0 + s] > 0) ? SOFTMAX_CLAMP : NEG_INF;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      float l = 0.f;
      for (int d = 0; d < HD; ++d) l = fmaf(Qs[r][d], Ks[lane][d], l);
      float kbv = kbias[lane];
      if (a.causal && k0 + lane > q0 + r) kbv = NEG_INF;
      const float p = expf(fminf(l, kbv));
      rowsum[rr] += p;
      for (int j = 0; j < FK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < F_HDMAX / 32; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) o[rr][i] = fmaf(pj, Vs[j][d], o[rr][i]);
        }
      }
    }
  }

  const int D = a.H * HD;
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int s = q0 + warp * 8 + rr;
    const float rs = fmaxf(warp_sum(rowsum[rr]), ROWSUM_FLOOR);
    if (s >= S) continue;
    float* orow = static_cast<float*>(a.out) + (row0 + s) * D + h * HD;
#pragma unroll
    for (int i = 0; i < F_HDMAX / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) orow[d] = (o[rr][i] / rs) * INV_VSCALE;
    }
  }
}

}  // namespace k1

// q, k, v: base pointers of head 0 of row 0; q_row / kv_row: row strides in
// elements (the batch stride is S rows).  out: contiguous (B, S, H·HD).
extern "C" int caco_attention(int dtype, const void* q, const void* k, const void* v, int q_row,
                              int kv_row, const int* mask, void* out, int B, int S, int H, int HD,
                              float q_scale, int causal, void* stream) {
  using namespace k1;
  if (B <= 0 || S <= 0 || H <= 0 || q_row <= 0 || kv_row <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AttnArgs a{q, k, v, static_cast<size_t>(q_row), static_cast<size_t>(kv_row), mask, out,
                   S, H, q_scale, causal};
  if (dtype == BF16) {
    const dim3 grid((S + AQ - 1) / AQ, H, B);
    if (HD == 64) {
      attention_bf16_kernel<64><<<grid, ATT_THREADS, 0, st>>>(a);
    } else if (HD == 96) {
      attention_bf16_kernel<96><<<grid, ATT_THREADS, 0, st>>>(a);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == F32) {
    if (HD <= 0 || HD > F_HDMAX) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((S + FQ - 1) / FQ, H, B);
    attention_f32_kernel<<<grid, ATT_THREADS, 0, st>>>(a, HD);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
