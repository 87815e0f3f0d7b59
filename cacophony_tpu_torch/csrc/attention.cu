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
// bf16 (attention_bf16_wgmma_kernel), FlashAttention-3's shape on Hopper:
// one block per (128 query rows, head, batch row); the (S, S) logits never
// leave registers.
//   - Q·Kᵀ on wgmma m64n128k16 with Q and K in shared memory (both K-major);
//     P·V on wgmma with P from registers (the RS form) and V in shared memory
//     (MN-major, transpose flag);
//   - Q is loaded once by TMA; one producer warp loads K, V tiles of 128
//     keys by TMA into a 2-stage ring (full/empty mbarriers), and writes each
//     tile's key bias; the producer warpgroup's three other warps multiply
//     each V tile by 2^-24 in place (V lands unscaled) while the consumers
//     run Q·Kᵀ and the softmax, and release it through a third barrier;
//     two consumer warpgroups of 64 query rows share every K/V tile;
//   - a head row of Dh = 96 (192 bytes) is wider than a 128-byte swizzle
//     span, so every operand is stored as 32-column boxes with a 64-byte
//     swizzle (3 boxes for Dh = 96, 2 for Dh = 64);
//   - 3-D tensor maps (columns, S, B) with the row stride, so TMA zero-fills
//     rows past S of each clip;
//   - p = ex2(min(l, bias)·log2 e), flushing p below 2^-126 (a logit under
//     ≈ -87) to 0 — such a row's P·V falls below fp32's normal range on the
//     tensor cores anyway; the max-free softmax needs no rescale.
// fp32: a plain shared-memory loop (one lane per key for the logits, one
// lane per output column for P·V); full fp32 has no tensor-core path.
// Causal: key tiles past the q tile's last row are skipped (their p is 0);
// so are key tiles past a clip's last valid key (bf16).
//
// Bound on the card: 4·H·Dh·S flops per valid key of each clip on the
// tensor cores (all keys valid at S = 1536, B = 32: 231.9 GFLOP per layer,
// 0.235 ms at 989 TFLOP/s), and as many exponentials on the SFUs; Q, K, V
// and the output are read and written once.
#include "hopper.cuh"

namespace k1 {

constexpr int AQ = 128;      // query rows per block (2 consumer warpgroups x 64)
constexpr int AKT = 128;     // keys per tile
constexpr int ASTAGES = 2;
constexpr int ATT_WG_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int ATT_THREADS = 128;     // the fp32 kernel
constexpr int ABOX = 32;     // columns per TMA box: 64 bytes, 64-byte swizzle
constexpr float LOG2E = 1.4426950408889634f;

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
struct AttnSmem {
  static constexpr int C = HD / ABOX;
  bf16 q[C][AQ * ABOX];
  bf16 k[ASTAGES][C][AKT * ABOX];
  bf16 v[ASTAGES][C][AKT * ABOX];
  float kbias[ASTAGES][AKT];
  uint64_t full[ASTAGES], empty[ASTAGES], vready[ASTAGES], qbar;
  int last_key;  // the last valid key of the clip before k_end, -1 if none
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(ATT_WG_THREADS, 1)
    attention_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const int* __restrict__ mask, bf16* __restrict__ out, int S,
                                int H, float q_scale, int causal) {
  constexpr int C = HD / ABOX;
  extern __shared__ unsigned char smem_raw[];
  AttnSmem<HD>& sm = *reinterpret_cast<AttnSmem<HD>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AQ;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  int k_end = causal ? min(S, q0 + AQ) : S;

  if (threadIdx.x == 0) {
    sm.last_key = -1;
    prefetch_tensor_map(&map_q);
    prefetch_tensor_map(&map_k);
    prefetch_tensor_map(&map_v);
    for (int s = 0; s < ASTAGES; ++s) {
      mbar_init(&sm.full[s], 32);  // every producer lane (the key bias), lane 0 with the bytes
      mbar_init(&sm.empty[s], 8);  // lane 0 of each consumer warp
      mbar_init(&sm.vready[s], 96);  // every thread of the scaling warps
    }
    mbar_init(&sm.qbar, 1);
    mbar_init_fence();
    // Q first: its load overlaps the key scan below
    mbar_arrive_expect_tx(&sm.qbar, C * AQ * ABOX * 2);
#pragma unroll
    for (int c = 0; c < C; ++c) tma_load_3d(sm.q[c], &map_q, &sm.qbar, h * HD + c * ABOX, q0, b);
  }
  __syncthreads();
  // Key tiles past the clip's last valid key hold only p = 0 and are skipped.
  {
    int last = -1;
    for (int j = threadIdx.x; j < k_end; j += ATT_WG_THREADS)
      if (mask[static_cast<size_t>(b) * S + j] > 0) last = j;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
    if (lane == 0 && last >= 0) atomicMax(&sm.last_key, last);
  }
  __syncthreads();
  k_end = min(k_end, sm.last_key + 1);

  if (wg == 0) {  // producer warp
    setmaxnreg_dec<40>();
    if (warp == 0) {
      RingPos pos;
      for (int k0 = 0; k0 < k_end; k0 += AKT) {
        mbar_wait(&sm.empty[pos.stage], pos.phase ^ 1u);
        for (int j = lane; j < AKT; j += 32) {
          const int s = k0 + j;
          sm.kbias[pos.stage][j] =
              (s < S && mask[static_cast<size_t>(b) * S + s] > 0) ? SOFTMAX_CLAMP : NEG_INF;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[pos.stage], 2 * C * AKT * ABOX * 2);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            tma_load_3d(sm.k[pos.stage][c], &map_k, &sm.full[pos.stage], h * HD + c * ABOX, k0, b);
            tma_load_3d(sm.v[pos.stage][c], &map_v, &sm.full[pos.stage], h * HD + c * ABOX, k0, b);
          }
        } else {
          mbar_arrive(&sm.full[pos.stage]);
        }
        pos.advance<ASTAGES>();
      }
    } else {  // warps 1-3: V·2^-24 in place, as the Pallas kernel pre-scales V
      RingPos pos;
      for (int k0 = 0; k0 < k_end; k0 += AKT) {
        mbar_wait(&sm.full[pos.stage], pos.phase);
        uint4* vt = reinterpret_cast<uint4*>(sm.v[pos.stage][0]);
        for (int i = tid - 32; i < C * AKT * ABOX / 8; i += 96) {
          uint4 v = vt[i];
          bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * VSCALE);
          vt[i] = v;
        }
        fence_proxy_async();
        mbar_arrive(&sm.vready[pos.stage]);
        pos.advance<ASTAGES>();
      }
    }
  } else {  // consumer warpgroup c: query rows 64c..64c+63 of the block
    setmaxnreg_inc<232>();
    const int cw = wg - 1, g = lane / 4, t = lane % 4;
    mbar_wait(&sm.qbar, 0);
    // q scaled in the compute dtype, in place (elementwise: the swizzle does not matter)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      uint4* rows = reinterpret_cast<uint4*>(sm.q[c] + cw * 64 * ABOX);
      for (int i = tid; i < 64 * ABOX / 8; i += 128) {
        uint4 v = rows[i];
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * q_scale);
        rows[i] = v;
      }
    }
    fence_proxy_async();
    warpgroup_bar(1 + cw);

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float rowsum[2] = {0.f, 0.f};  // rows g and g + 8 of this warp
    const int row0 = q0 + cw * 64 + warp * 16 + g;
    RingPos pos;
    for (int k0 = 0; k0 < k_end; k0 += AKT) {
      mbar_wait(&sm.full[pos.stage], pos.phase);
      float sc[AKT / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint64_t dq = smem_desc(sm.q[ks / 2] + cw * 64 * ABOX + (ks % 2) * 16, 16, 512, SW64);
        const uint64_t dk = smem_desc(sm.k[pos.stage][ks / 2] + (ks % 2) * 16, 16, 512, SW64);
        wgmma_ss_n128<0>(sc, dq, dk, ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // clamp + exp in fp32; the row sums take p, P·V takes bf16(p)
      const float* kb = sm.kbias[pos.stage];
      unsigned pf[AKT / 16][4];
#pragma unroll
      for (int j = 0; j < AKT / 8; ++j) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          float kbv = kb[col];
          if (causal && k0 + col > row0 + (e >> 1) * 8) kbv = NEG_INF;
          const float p = ex2(fminf(sc[4 * j + e], kbv) * LOG2E);
          rowsum[e >> 1] += p;
          pv[e] = p;
        }
        pf[j / 2][(j % 2) * 2] = pack_bf16x2(pv[0], pv[1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(pv[2], pv[3]);
      }

      // o += P (64 x 128) · V·2^-24 (128 x HD)
      mbar_wait(&sm.vready[pos.stage], pos.phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < AKT / 16; ++kk) {
        const uint64_t dv = smem_desc(sm.v[pos.stage][0] + kk * 16 * ABOX, AKT * ABOX * 2, 512, SW64);
        if constexpr (HD == 96)
          wgmma_rs_n96(o, pf[kk], dv);
        else
          wgmma_rs_n64(o, pf[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&sm.empty[pos.stage]);
      pos.advance<ASTAGES>();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 1);
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 2);
      rowsum[i] = fmaxf(rowsum[i], ROWSUM_FLOOR);
    }
    const int D = H * HD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = row0 + half * 8;
      if (s >= S) continue;
      bf16* orow = out + (static_cast<size_t>(b) * S + s) * D + h * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float v0 = (o[4 * n + half * 2] / rowsum[half]) * INV_VSCALE;
        const float v1 = (o[4 * n + half * 2 + 1] / rowsum[half]) * INV_VSCALE;
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int HD>
cudaError_t launch_attention_bf16(const AttnArgs& a, int B, cudaStream_t st) {
  const uint64_t D = static_cast<uint64_t>(a.H) * HD;
  CUtensorMap maps[3];
  const void* bases[3] = {a.q, a.k, a.v};
  const size_t rows[3] = {a.q_row, a.kv_row, a.kv_row};
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[3] = {D, static_cast<uint64_t>(a.S), static_cast<uint64_t>(B)};
    const uint64_t strides[2] = {rows[i] * 2, rows[i] * 2 * a.S};
    const uint32_t box[3] = {ABOX, static_cast<uint32_t>(i == 0 ? AQ : AKT), 1};
    if (!make_tensor_map(&maps[i], bases[i], 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B))
      return cudaErrorInvalidValue;
  }
  auto kernel = attention_bf16_wgmma_kernel<HD>;
  constexpr size_t smem = sizeof(AttnSmem<HD>) + 1024;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + AQ - 1) / AQ, a.H, B);
  kernel<<<grid, ATT_WG_THREADS, smem, st>>>(maps[0], maps[1], maps[2], a.mask,
                                          static_cast<bf16*>(a.out), a.S, a.H, a.q_scale,
                                          a.causal);
  return cudaSuccess;
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
    cudaError_t err;
    if (HD == 64) {
      err = launch_attention_bf16<64>(a, B, st);
    } else if (HD == 96) {
      err = launch_attention_bf16<96>(a, B, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (dtype == F32) {
    if (HD <= 0 || HD > F_HDMAX) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((S + FQ - 1) / FQ, H, B);
    attention_f32_kernel<<<grid, ATT_THREADS, 0, st>>>(a, HD);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
