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
// bf16 at any other head dim (1..128): attention_bf16_mma_kernel, mma.sync
// with the head row rounded up to 16, 32, 64, 96 or 128 zero-filled columns.
// fp32 (attention_f32_kernel): a register-tiled flash attention on the FMA
// units, described above the kernel; Dh rounded up to 32, 64, 96 or 128.
// Every kernel skips key tiles past a clip's last valid key and, causal,
// past the q tile's last row (their p is 0).
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

// The clip's last valid key before k_lim, -1 if none (a block-wide scan:
// every thread calls it; `slot` is a shared int).  Key tiles past it hold
// only p = 0 and are skipped.
__device__ __forceinline__ int last_valid_key(const int* mask_row, int k_lim, int* slot) {
  if (threadIdx.x == 0) *slot = -1;
  __syncthreads();
  int last = -1;
  for (int j = threadIdx.x; j < k_lim; j += blockDim.x)
    if (mask_row[j] > 0) last = j;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  if ((threadIdx.x & 31) == 0 && last >= 0) atomicMax(slot, last);
  __syncthreads();
  return *slot;
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
  if (threadIdx.x == 0) {
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
  // (the scan's first barrier also publishes the mbarrier inits)
  const int k_lim = causal ? min(S, q0 + AQ) : S;
  const int k_end = min(k_lim, last_valid_key(mask + static_cast<size_t>(b) * S, k_lim, &sm.last_key) + 1);

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

// ---- bf16 at head dims other than 64 and 96: mma.sync m16n8k16 --------------
// One block of 4 warps per (64 query rows, head, batch row), each warp 16
// rows with q in registers; K and V tiles of 32 keys in shared memory, the
// head row rounded up to HDP columns with zeros (zero columns add exact
// zeros to every product); P goes from the logit accumulators straight into
// the A fragments of P·V.
constexpr int MQ = 64, MKT = 32, M_THREADS = 128;

template <int HDP>
__global__ void __launch_bounds__(M_THREADS)
    attention_bf16_mma_kernel(AttnArgs a, int HD, int vec) {
  constexpr int LD = HDP + 8, CH = HDP / 8;
  __shared__ __align__(16) bf16 Qs[MQ * LD];
  __shared__ __align__(16) bf16 Ks[MKT * LD];
  __shared__ __align__(16) bf16 Vs[MKT * LD];
  __shared__ float kbias[MKT];
  __shared__ int last_key;

  const int S = a.S, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * MQ;
  const size_t row0 = static_cast<size_t>(b) * S, hoff = static_cast<size_t>(h) * HD;
  const bf16* qb = static_cast<const bf16*>(a.q) + row0 * a.q_row + hoff;
  const bf16* kb = static_cast<const bf16*>(a.k) + row0 * a.kv_row + hoff;
  const bf16* vb = static_cast<const bf16*>(a.v) + row0 * a.kv_row + hoff;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;

  // q scaled in the compute dtype
  for (int c = tid; c < MQ * CH; c += M_THREADS) {
    const int r = c / CH, ch = c % CH, s = q0 + r;
    uint4 qv = load_cols8(qb + static_cast<size_t>(s) * a.q_row, ch * 8, HD, vec, s < S);
    bf16* e = reinterpret_cast<bf16*>(&qv);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * a.q_scale);
    *reinterpret_cast<uint4*>(&Qs[r * LD + ch * 8]) = qv;
  }
  const int k_lim = a.causal ? min(S, q0 + MQ) : S;
  const int k_end = min(k_lim, last_valid_key(a.mask + row0, k_lim, &last_key) + 1);
  unsigned qf[HDP / 16][4];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) frag_a(qf[kk], Qs, LD, warp * 16, kk * 16);

  float o[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float rowsum[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  for (int k0 = 0; k0 < k_end; k0 += MKT) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < MKT * CH; c += M_THREADS) {
      const int r = c / CH, ch = c % CH, s = k0 + r;
      const size_t off = static_cast<size_t>(s) * a.kv_row;
      *reinterpret_cast<uint4*>(&Ks[r * LD + ch * 8]) = load_cols8(kb + off, ch * 8, HD, vec, s < S);
      uint4 vv = load_cols8(vb + off, ch * 8, HD, vec, s < S);
      bf16* e = reinterpret_cast<bf16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * VSCALE);
      *reinterpret_cast<uint4*>(&Vs[r * LD + ch * 8]) = vv;
    }
    for (int j = tid; j < MKT; j += M_THREADS) {
      const int s = k0 + j;
      kbias[j] = (s < S && a.mask[row0 + s] > 0) ? SOFTMAX_CLAMP : NEG_INF;
    }
    __syncthreads();
    float sc[MKT / 8][4];
#pragma unroll
    for (int n = 0; n < MKT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < MKT / 16; ++nj) {
        unsigned kf[4];
        frag_b_nk(kf, Ks, LD, nj * 16, kk * 16);
        mma_bf16(sc[2 * nj], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[2 * nj + 1], qf[kk], kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < MKT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        float kbv = kbias[col];
        if (a.causal && k0 + col > row[e >> 1]) kbv = NEG_INF;
        const float p = expf(fminf(sc[n][e], kbv));
        rowsum[e >> 1] += p;
        sc[n][e] = p;
      }
    unsigned pf[MKT / 16][4];
    acc_to_a<MKT / 8>(pf, sc);
#pragma unroll
    for (int kk = 0; kk < MKT / 16; ++kk) {
#pragma unroll
      for (int dj = 0; dj < HDP / 16; ++dj) {
        unsigned vf[4];
        frag_b_kn(vf, Vs, LD, kk * 16, dj * 16);
        mma_bf16(o[2 * dj], pf[kk], vf[0], vf[1]);
        mma_bf16(o[2 * dj + 1], pf[kk], vf[2], vf[3]);
      }
    }
  }

  const size_t D = static_cast<size_t>(a.H) * HD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float rs = fmaxf(quad_sum(rowsum[half]), ROWSUM_FLOOR);
    const int s = row[half];
    if (s >= S) continue;
    bf16* orow = static_cast<bf16*>(a.out) + (row0 + s) * D + hoff;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n)
      store_cols2(orow, n * 8 + 2 * t, HD, vec, (o[n][half * 2] / rs) * INV_VSCALE,
                  (o[n][half * 2 + 1] / rs) * INV_VSCALE);
  }
}

// ---- fp32: a register-tiled flash attention on the FMA units ----------------
// Full fp32 has no tensor-core product (TF32 keeps 10 mantissa bits), so
// the bound is 4·Dh FMAs per (query, valid key) at 67 TFLOP/s.  One block
// of 256 threads takes 64 query rows of one head; key tiles of 64:
//   - each thread owns a 4x4 micro-tile of the logits (rows ty + 16i, keys
//     tx + 16j) and a 4 x HDP/16 tile of the output (rows ty + 16i, column
//     pairs 2tx + 32c), so one float4 shared load feeds 4 FMAs for each
//     of its rows (Q·Kᵀ) and one P float4 16 (P·V);
//   - Q (scaled once), one K and one V tile live in shared memory as rows
//     of HDP + 4 floats: a warp's threads are 4 query rows x 8 keys, and 8
//     consecutive rows 4 banks apart make every float4 read one wavefront;
//   - the K and V buffers form a 2-stage ring of their own: V of tile t
//     lands by cp.async while Q·Kᵀ of tile t runs, K of tile t + 1 while
//     P·V of tile t runs (16-byte copies where the rows allow, zero-filled
//     past S and Dh); with one buffer each a block needs 94 KB at Dh 96,
//     so two blocks share an SM and hide each other's barriers;
//   - V·2^-24 is applied in shared memory by the thread that copied each
//     element (exact in fp32, the Pallas order); p = exp(min(l, bias)) in
//     registers, staged in shared memory for P·V; the max-free softmax
//     needs no rescale between tiles;
//   - key tiles past the clip's last valid key (and, causal, past the
//     block's last query) are skipped.
constexpr int FQ = 64, FKT = 64, F_THREADS = 256;
constexpr int F_PLD = FKT + 8;  // P rows 8 banks apart: a warp's writes are conflict-free

template <int HDP>
struct F32AttnSmem {
  static constexpr int LD = HDP + 4;
  float q[FQ * LD];
  float k[FKT * LD];
  float v[FKT * LD];
  float p[FQ * F_PLD];
  float kbias[FKT];
  float rowsum[2][FQ];  // the two warps that share a query row
  int last_key;
};

// ROWS rows from r0 of an fp32 head slice (row stride `stride`) into shared
// rows HDP + 4 apart, zeros past S rows and hd columns; 16-byte copies when
// `vec` (hd and the strides multiples of 4, 16-byte aligned bases).
template <int HDP, int ROWS>
__device__ __forceinline__ void f32_rows_async(float* dst, const float* src, size_t stride, int r0,
                                               int S, int hd, bool vec) {
  constexpr int LD = HDP + 4;
  if (vec) {
    for (int e = threadIdx.x; e < ROWS * HDP / 4; e += F_THREADS) {
      const int r = e / (HDP / 4), c = (e % (HDP / 4)) * 4, s = r0 + r;
      const bool ok = s < S && c < hd;
      cp_async16(dst + r * LD + c, ok ? src + static_cast<size_t>(s) * stride + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * HDP; e += F_THREADS) {
      const int r = e / HDP, c = e % HDP, s = r0 + r;
      const bool ok = s < S && c < hd;
      cp_async4(dst + r * LD + c, ok ? src + static_cast<size_t>(s) * stride + c : src, ok ? 4 : 0);
    }
  }
}

// The elements this thread copied with f32_rows_async (the same walk),
// times `scale`, once its copies have landed (cp_async_wait).
template <int HDP, int ROWS>
__device__ __forceinline__ void f32_rows_scale(float* dst, bool vec, float scale) {
  constexpr int LD = HDP + 4;
  if (vec) {
    for (int e = threadIdx.x; e < ROWS * HDP / 4; e += F_THREADS) {
      float4* p = reinterpret_cast<float4*>(dst + (e / (HDP / 4)) * LD + (e % (HDP / 4)) * 4);
      float4 x = *p;
      x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
      *p = x;
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * HDP; e += F_THREADS) dst[(e / HDP) * LD + e % HDP] *= scale;
  }
}

__device__ __forceinline__ float f4_at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int HDP>
__global__ void __launch_bounds__(F_THREADS, HDP <= 96 ? 2 : 1)
    attention_f32_kernel(AttnArgs a, int HD, int vec) {
  constexpr int LD = HDP + 4, CP = HDP / 32;  // column pairs per thread
  extern __shared__ __align__(16) unsigned char smem_f32[];
  F32AttnSmem<HDP>& sm = *reinterpret_cast<F32AttnSmem<HDP>*>(smem_f32);
  const int S = a.S, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const size_t row0 = static_cast<size_t>(b) * S, hoff = static_cast<size_t>(h) * HD;
  const float* qb = static_cast<const float*>(a.q) + row0 * a.q_row + hoff;
  const float* kb = static_cast<const float*>(a.k) + row0 * a.kv_row + hoff;
  const float* vb = static_cast<const float*>(a.v) + row0 * a.kv_row + hoff;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);

  f32_rows_async<HDP, FQ>(sm.q, qb, a.q_row, q0, S, HD, vec);
  cp_async_commit();
  const int k_lim = a.causal ? min(S, q0 + FQ) : S;
  const int k_end = min(k_lim, last_valid_key(a.mask + row0, k_lim, &sm.last_key) + 1);
  const int n_tiles = (k_end + FKT - 1) / FKT;
  auto load_k = [&](int t) {
    const int k0 = t * FKT;
    f32_rows_async<HDP, FKT>(sm.k, kb, a.kv_row, k0, S, HD, vec);
    for (int j = tid; j < FKT; j += F_THREADS) {
      const int s = k0 + j;
      sm.kbias[j] = (s < S && a.mask[row0 + s] > 0) ? SOFTMAX_CLAMP : NEG_INF;
    }
  };
  if (n_tiles > 0) load_k(0);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's Q copies have landed
  f32_rows_scale<HDP, FQ>(sm.q, vec, a.q_scale);

  float o[4][CP][2], rs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rs[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CP; ++c) o[i][c][0] = o[i][c][1] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * FKT;
    cp_async_wait<0>();
    __syncthreads();  // K of tile t and scaled Q are visible; P·V of tile t - 1 is done
    f32_rows_async<HDP, FKT>(sm.v, vb, a.kv_row, k0, S, HD, vec);
    cp_async_commit();

    // logits: rows ty + 16i x keys tx + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(&sm.q[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = *reinterpret_cast<const float4*>(&sm.k[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qa[i].x, ka[j].x, sc[i][j]);
          sc[i][j] = fmaf(qa[i].y, ka[j].y, sc[i][j]);
          sc[i][j] = fmaf(qa[i].z, ka[j].z, sc[i][j]);
          sc[i][j] = fmaf(qa[i].w, ka[j].w, sc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        float kbv = sm.kbias[kc];
        if (a.causal && k0 + kc > q0 + ty + 16 * i) kbv = NEG_INF;
        const float p = expf(fminf(sc[i][j], kbv));
        rs[i] += p;
        sm.p[(ty + 16 * i) * F_PLD + kc] = p;
      }
    cp_async_wait<0>();
    f32_rows_scale<HDP, FKT>(sm.v, vec, VSCALE);  // V·2^-24, as the Pallas kernel pre-scales V
    __syncthreads();  // P and the scaled V are visible; Q·Kᵀ of tile t is done
    if (t + 1 < n_tiles) load_k(t + 1);
    cp_async_commit();

    // o += P · V·2^-24: rows ty + 16i x column pairs 2tx + 32c
#pragma unroll 2
    for (int kk = 0; kk < FKT; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(&sm.p[(ty + 16 * i) * F_PLD + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = &sm.v[(kk + u) * LD + 2 * tx];
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const float2 vv = *reinterpret_cast<const float2*>(&vr[32 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pu = f4_at(pa[i], u);
            o[i][c][0] = fmaf(pu, vv.x, o[i][c][0]);
            o[i][c][1] = fmaf(pu, vv.y, o[i][c][1]);
          }
        }
      }
    }
  }

  // row sums: the 8 lanes of a warp that share a row, then the two warps
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
    if ((lane & 7) == 0) sm.rowsum[warp & 1][ty + 16 * i] = rs[i];
  }
  __syncthreads();
  const size_t D = static_cast<size_t>(a.H) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= S) continue;
    const float sum = fmaxf(sm.rowsum[0][r] + sm.rowsum[1][r], ROWSUM_FLOOR);
    float* orow = static_cast<float*>(a.out) + (row0 + s) * D + hoff;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      const int col = 2 * tx + 32 * c;
      if (col < HD) orow[col] = (o[i][c][0] / sum) * INV_VSCALE;
      if (col + 1 < HD) orow[col + 1] = (o[i][c][1] / sum) * INV_VSCALE;
    }
  }
}

template <int HDP>
cudaError_t launch_attention_mma(const AttnArgs& a, int B, int HD, int vec, cudaStream_t st) {
  attention_bf16_mma_kernel<HDP><<<dim3((a.S + MQ - 1) / MQ, a.H, B), M_THREADS, 0, st>>>(a, HD, vec);
  return cudaSuccess;
}

template <int HDP>
cudaError_t launch_attention_f32(const AttnArgs& a, int B, int HD, int vec, cudaStream_t st) {
  auto kernel = attention_f32_kernel<HDP>;
  constexpr size_t smem = sizeof(F32AttnSmem<HDP>);
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3((a.S + FQ - 1) / FQ, a.H, B), F_THREADS, smem, st>>>(a, HD, vec);
  return cudaSuccess;
}

}  // namespace k1

// q, k, v: base pointers of head 0 of row 0; q_row / kv_row: row strides in
// elements (the batch stride is S rows).  out: contiguous (B, S, H·HD).
// Any head dim from 1 to 128 (MAX_HEAD_DIM in ops/_kernels.py).  bf16 at
// Dh 64 or 96 with rows TMA can describe (16-byte aligned bases, strides of
// 8 elements) runs the wgmma kernel, any other bf16 head the mma.sync one;
// fp32 the register-tiled kernel, each with Dh rounded up to its tile width.
extern "C" int caco_attention(int dtype, const void* q, const void* k, const void* v, int q_row,
                              int kv_row, const int* mask, void* out, int B, int S, int H, int HD,
                              float q_scale, int causal, void* stream) {
  using namespace k1;
  if (B <= 0 || S <= 0 || H <= 0 || HD <= 0 || HD > 128 || q_row <= 0 || kv_row <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AttnArgs a{q, k, v, static_cast<size_t>(q_row), static_cast<size_t>(kv_row), mask, out,
                   S, H, q_scale, causal};
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  cudaError_t err;
  if (dtype == BF16) {
    const int vec = aligned && HD % 8 == 0 && q_row % 8 == 0 && kv_row % 8 == 0;
    if (vec && HD == 64) {
      err = launch_attention_bf16<64>(a, B, st);
    } else if (vec && HD == 96) {
      err = launch_attention_bf16<96>(a, B, st);
    } else if (HD <= 16) {
      err = launch_attention_mma<16>(a, B, HD, vec, st);
    } else if (HD <= 32) {
      err = launch_attention_mma<32>(a, B, HD, vec, st);
    } else if (HD <= 64) {
      err = launch_attention_mma<64>(a, B, HD, vec, st);
    } else if (HD <= 96) {
      err = launch_attention_mma<96>(a, B, HD, vec, st);
    } else {
      err = launch_attention_mma<128>(a, B, HD, vec, st);
    }
  } else if (dtype == F32) {
    const int vec = aligned && HD % 4 == 0 && q_row % 4 == 0 && kv_row % 4 == 0;
    if (HD <= 32) {
      err = launch_attention_f32<32>(a, B, HD, vec, st);
    } else if (HD <= 64) {
      err = launch_attention_f32<64>(a, B, HD, vec, st);
    } else if (HD <= 96) {
      err = launch_attention_f32<96>(a, B, HD, vec, st);
    } else {
      err = launch_attention_f32<128>(a, B, HD, vec, st);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
