// K7: the backward of K4's masked attention over the fused (B, S, 3D) QKV.
//
// Replaces `_pallas_backward` (cacophony_tpu/ops/encoder_attention.py:1147,
// kernel `_bwd_kernel:1100`) and computes what it computes, per head:
//   P   = exp(min(l, kbias)) / max(rowsum, 1e-37), l from q scaled by
//         1/sqrt(Dh) rounded to the compute dtype T (as the forward);
//   dV  = T(P)ᵀ · dO
//   dP  = dO · Vᵀ                          (fp32)
//   dS  = P ∘ (dP − rowsum(dP ∘ P)), zeroed on masked keys, times the fp32
//         1/sqrt(Dh)
//   dQ  = T(dS) · K,  dK = T(dS)ᵀ · Q      (Q unscaled)
// with dO the incoming gradient cast to T and every product accumulated in
// fp32.  The output is dqkv in the fused layout.
//
// On the TPU one grid step held a batch row's (S, S) P and dP tiles in
// VMEM.  An H100 block has 227 KB of shared memory, so this is the
// flash-style split, and no (S, S) tensor goes to device memory:
//   kernel A, one block per (64-query tile, head, row): three sweeps over
//     32-key tiles — the row sums, then Δ = Σ P∘dP, then dQ — and it
//     stores the fp32 row sum and Δ of each (row, head, query);
//   kernel B, one block per (64-key tile, head, row): a loop over 32-query
//     tiles that recomputes P from the stored row sums, accumulates dV and
//     dK in registers, and needs Δ only as a number per query.
// Fully masked rows have P = 0 everywhere, so their gradients are 0.
// bf16: mma.sync m16n8k16, four warps of 16 rows, products straight from
// the accumulators into the next product's A fragments (csrc/k1_common.cuh),
// the head row rounded up to HDP columns loaded as zeros.  fp32:
// shared-memory FMA loops (lane per key or per query) over the first Dh of
// FHD columns.  Causal: tiles wholly after the diagonal are skipped (P = 0).
//
// Bound on the card: kernel A recomputes Q·Kᵀ three times and dO·Vᵀ twice
// per tile, kernel B each once; ~11·S²·Dh flops per head against ~4 for
// the forward, mma.sync issue and the exp per logit (tensor cores at a
// fraction of peak).  The fused rewrite into one pass with atomics for dQ
// is later work.
#include "k1_common.cuh"

namespace k1 {

constexpr int BWD_THREADS = 128;
constexpr int QA = 64;  // kernel A: query rows per block (4 warps x 16)
constexpr int KA = 32;  // kernel A: keys per tile
constexpr int KB = 64;  // kernel B: keys per block (4 warps x 16)
constexpr int QB = 32;  // kernel B: queries per tile
constexpr int F_QA = 16;  // fp32 kernel A: query rows per block (4 warps x 4)
constexpr int F_KB = 16;  // fp32 kernel B: keys per block (4 warps x 4)
constexpr int F_T = 32;   // fp32: keys (A) or queries (B) per tile, one per lane

struct BwdArgs {
  const void* qkv;  // (B, S, 3D)
  const int* mask;  // (B, S), > 0 = valid key
  const void* g;    // (B, S, D), the gradient of the output, in the compute dtype
  void* dqkv;       // (B, S, 3D)
  float* stats;     // (2, B, H, S): row sums, then Δ
  int B, S, H;
  int HD;           // the head dim, at most the kernel's tile width
  int vec;          // 16-byte row loads (HD a multiple of 8, 16-byte aligned bases)
  float q_scale;   // 1/sqrt(Dh) in the compute dtype
  float ds_scale;  // 1/sqrt(Dh) in fp32
  int causal;
};

// ------------------------------------------------------------------ bf16

// Shared memory of the bf16 kernels (dynamic: past 48 KB at HDP = 128).
// Rows HDP + 8 elements apart keep ldmatrix conflict-free.
template <int HDP>
struct BwdQBf16Smem {
  static constexpr int LD = HDP + 8;
  bf16 Qs[QA * LD];  // q, scaled
  bf16 Os[QA * LD];  // dO
  bf16 Ks[KA * LD];
  bf16 Vs[KA * LD];
  float kbias[KA];
  float kvalid[KA];
};

template <int HDP>
struct BwdKVBf16Smem {
  static constexpr int LD = HDP + 8;
  bf16 Ks[KB * LD];
  bf16 Vs[KB * LD];
  bf16 Qs[QB * LD];  // q, scaled: the logits
  bf16 Qr[QB * LD];  // q as it is: dK
  bf16 Os[QB * LD];  // dO
  float rsum[QB];
  float delta[QB];
};

template <int HDP>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_q_bf16(BwdArgs a) {
  constexpr int LD = HDP + 8, CH = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  BwdQBf16Smem<HDP>& sm = *reinterpret_cast<BwdQBf16Smem<HDP>*>(smem_bwd);
  bf16* Qs = sm.Qs;
  bf16* Os = sm.Os;
  bf16* Ks = sm.Ks;
  bf16* Vs = sm.Vs;
  float* kbias = sm.kbias;
  float* kvalid = sm.kvalid;

  const int S = a.S, H = a.H, HD = a.HD, D = H * HD, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QA;
  const size_t row0 = static_cast<size_t>(b) * S, ld3 = 3 * static_cast<size_t>(D);
  const bf16* x = static_cast<const bf16*>(a.qkv) + row0 * ld3 + static_cast<size_t>(h) * HD;
  const bf16* go = static_cast<const bf16*>(a.g) + row0 * D + static_cast<size_t>(h) * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  for (int c = tid; c < QA * CH; c += BWD_THREADS) {
    const int r = c / CH, ch = c % CH, s = q0 + r;
    uint4 qv = load_cols8(x + s * ld3, ch * 8, HD, a.vec, s < S);
    bf16* e = reinterpret_cast<bf16*>(&qv);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * a.q_scale);
    *reinterpret_cast<uint4*>(&Qs[r * LD + ch * 8]) = qv;
    *reinterpret_cast<uint4*>(&Os[r * LD + ch * 8]) = load_cols8(go + static_cast<size_t>(s) * D, ch * 8, HD, a.vec, s < S);
  }
  __syncthreads();
  unsigned qf[HDP / 16][4], of[HDP / 16][4];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    frag_a(qf[kk], Qs, LD, warp * 16, kk * 16);
    frag_a(of[kk], Os, LD, warp * 16, kk * 16);
  }
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int k_end = a.causal ? min(S, q0 + QA) : S;

  auto load_tile = [&](int k0) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < KA * CH; c += BWD_THREADS) {
      const int r = c / CH, ch = c % CH, s = k0 + r;
      *reinterpret_cast<uint4*>(&Ks[r * LD + ch * 8]) = load_cols8(x + s * ld3 + D, ch * 8, HD, a.vec, s < S);
      *reinterpret_cast<uint4*>(&Vs[r * LD + ch * 8]) = load_cols8(x + s * ld3 + 2 * D, ch * 8, HD, a.vec, s < S);
    }
    for (int j = tid; j < KA; j += BWD_THREADS) {
      const int s = k0 + j;
      const bool ok = s < S && a.mask[row0 + s] > 0;
      kbias[j] = ok ? SOFTMAX_CLAMP : NEG_INF;
      kvalid[j] = ok ? 1.f : 0.f;
    }
    __syncthreads();
  };
  // p̃ = exp(min(q·k, kbias)) for this warp's 16 rows x the tile's 32 keys
  auto probs = [&](float (&sc)[KA / 8][4], int k0) {
#pragma unroll
    for (int n = 0; n < KA / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < KA / 16; ++nj) {
        unsigned kf[4];
        frag_b_nk(kf, Ks, LD, nj * 16, kk * 16);
        mma_bf16(sc[2 * nj], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[2 * nj + 1], qf[kk], kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < KA / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        float kbv = kbias[c];
        if (a.causal && k0 + c > row[e >> 1]) kbv = NEG_INF;
        sc[n][e] = expf(fminf(sc[n][e], kbv));
      }
  };
  // dP = dO · Vᵀ for the same rows and keys
  auto grad_p = [&](float (&dp)[KA / 8][4]) {
#pragma unroll
    for (int n = 0; n < KA / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < KA / 16; ++nj) {
        unsigned vf[4];
        frag_b_nk(vf, Vs, LD, nj * 16, kk * 16);
        mma_bf16(dp[2 * nj], of[kk], vf[0], vf[1]);
        mma_bf16(dp[2 * nj + 1], of[kk], vf[2], vf[3]);
      }
    }
  };

  float sc[KA / 8][4], dp[KA / 8][4];
  float rs[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < k_end; k0 += KA) {  // sweep 1: row sums
    load_tile(k0);
    probs(sc, k0);
#pragma unroll
    for (int n = 0; n < KA / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e >> 1] += sc[n][e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) rs[i] = fmaxf(quad_sum(rs[i]), ROWSUM_FLOOR);

  for (int k0 = 0; k0 < k_end; k0 += KA) {  // sweep 2: Δ = Σ P ∘ dP
    load_tile(k0);
    probs(sc, k0);
    grad_p(dp);
#pragma unroll
    for (int n = 0; n < KA / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dl[e >> 1] += (sc[n][e] / rs[e >> 1]) * dp[n][e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) dl[i] = quad_sum(dl[i]);

  float dq[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += KA) {  // sweep 3: dQ += T(dS) · K
    load_tile(k0);
    probs(sc, k0);
    grad_p(dp);
#pragma unroll
    for (int n = 0; n < KA / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sc[n][e] / rs[e >> 1];
        const float ds = kvalid[n * 8 + 2 * t + (e & 1)] > 0.f ? p * (dp[n][e] - dl[e >> 1]) : 0.f;
        sc[n][e] = ds * a.ds_scale;
      }
    unsigned df[KA / 16][4];
    acc_to_a<KA / 8>(df, sc);
#pragma unroll
    for (int kk = 0; kk < KA / 16; ++kk) {
#pragma unroll
      for (int dj = 0; dj < HDP / 16; ++dj) {
        unsigned kf[4];
        frag_b_kn(kf, Ks, LD, kk * 16, dj * 16);
        mma_bf16(dq[2 * dj], df[kk], kf[0], kf[1]);
        mma_bf16(dq[2 * dj + 1], df[kk], kf[2], kf[3]);
      }
    }
  }

  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;
  const size_t n_stat = static_cast<size_t>(a.B) * H * S;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row[half];
    if (s >= S) continue;
    bf16* drow = static_cast<bf16*>(a.dqkv) + (row0 + s) * ld3 + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n)
      store_cols2(drow, n * 8 + 2 * t, HD, a.vec, dq[n][half * 2], dq[n][half * 2 + 1]);
    if (t == 0) {
      a.stats[stat0 + s] = rs[half];
      a.stats[n_stat + stat0 + s] = dl[half];
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_kv_bf16(BwdArgs a) {
  constexpr int LD = HDP + 8, CH = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  BwdKVBf16Smem<HDP>& sm = *reinterpret_cast<BwdKVBf16Smem<HDP>*>(smem_bwd);
  bf16* Ks = sm.Ks;
  bf16* Vs = sm.Vs;
  bf16* Qs = sm.Qs;
  bf16* Qr = sm.Qr;
  bf16* Os = sm.Os;
  float* rsum = sm.rsum;
  float* delta = sm.delta;

  const int S = a.S, H = a.H, HD = a.HD, D = H * HD, b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * KB;
  const size_t row0 = static_cast<size_t>(b) * S, ld3 = 3 * static_cast<size_t>(D);
  const bf16* x = static_cast<const bf16*>(a.qkv) + row0 * ld3 + static_cast<size_t>(h) * HD;
  const bf16* go = static_cast<const bf16*>(a.g) + row0 * D + static_cast<size_t>(h) * HD;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;
  const size_t n_stat = static_cast<size_t>(a.B) * H * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  for (int c = tid; c < KB * CH; c += BWD_THREADS) {
    const int r = c / CH, ch = c % CH, s = k0 + r;
    *reinterpret_cast<uint4*>(&Ks[r * LD + ch * 8]) = load_cols8(x + s * ld3 + D, ch * 8, HD, a.vec, s < S);
    *reinterpret_cast<uint4*>(&Vs[r * LD + ch * 8]) = load_cols8(x + s * ld3 + 2 * D, ch * 8, HD, a.vec, s < S);
  }
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float kbv[2];
  bool kok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kok[i] = key[i] < S && a.mask[row0 + key[i]] > 0;
    kbv[i] = kok[i] ? SOFTMAX_CLAMP : NEG_INF;
  }

  float dk[HDP / 8][4], dv[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int q_begin = a.causal ? (k0 / QB) * QB : 0;
  for (int q0 = q_begin; q0 < S; q0 += QB) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < QB * CH; c += BWD_THREADS) {
      const int r = c / CH, ch = c % CH, s = q0 + r;
      uint4 qv = load_cols8(x + s * ld3, ch * 8, HD, a.vec, s < S);
      *reinterpret_cast<uint4*>(&Qr[r * LD + ch * 8]) = qv;
      bf16* e = reinterpret_cast<bf16*>(&qv);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * a.q_scale);
      *reinterpret_cast<uint4*>(&Qs[r * LD + ch * 8]) = qv;
      *reinterpret_cast<uint4*>(&Os[r * LD + ch * 8]) = load_cols8(go + static_cast<size_t>(s) * D, ch * 8, HD, a.vec, s < S);
    }
    for (int j = tid; j < QB; j += BWD_THREADS) {
      const int s = q0 + j;
      rsum[j] = s < S ? a.stats[stat0 + s] : 1.f;
      delta[j] = s < S ? a.stats[n_stat + stat0 + s] : 0.f;
    }
    __syncthreads();

    // Pᵀ: this warp's 16 keys x the tile's 32 queries
    float st[QB / 8][4], dpt[QB / 8][4];
#pragma unroll
    for (int n = 0; n < QB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      unsigned kf[4], vf[4];
      frag_a(kf, Ks, LD, warp * 16, kk * 16);
      frag_a(vf, Vs, LD, warp * 16, kk * 16);
#pragma unroll
      for (int nj = 0; nj < QB / 16; ++nj) {
        unsigned qf[4], of[4];
        frag_b_nk(qf, Qs, LD, nj * 16, kk * 16);
        frag_b_nk(of, Os, LD, nj * 16, kk * 16);
        mma_bf16(st[2 * nj], kf, qf[0], qf[1]);
        mma_bf16(st[2 * nj + 1], kf, qf[2], qf[3]);
        mma_bf16(dpt[2 * nj], vf, of[0], of[1]);  // dPᵀ = V · dOᵀ
        mma_bf16(dpt[2 * nj + 1], vf, of[2], of[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < QB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t + (e & 1), q = q0 + qc;
        float kb = kbv[e >> 1];
        if (a.causal && key[e >> 1] > q) kb = NEG_INF;
        const float p = q < S ? expf(fminf(st[n][e], kb)) / rsum[qc] : 0.f;
        st[n][e] = p;
        const float ds = kok[e >> 1] ? p * (dpt[n][e] - delta[qc]) : 0.f;
        dpt[n][e] = ds * a.ds_scale;
      }
    unsigned pf[QB / 16][4], df[QB / 16][4];
    acc_to_a<QB / 8>(pf, st);
    acc_to_a<QB / 8>(df, dpt);
    // dV += T(P)ᵀ · dO, dK += T(dS)ᵀ · Q
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk) {
#pragma unroll
      for (int dj = 0; dj < HDP / 16; ++dj) {
        unsigned of[4], qf[4];
        frag_b_kn(of, Os, LD, kk * 16, dj * 16);
        frag_b_kn(qf, Qr, LD, kk * 16, dj * 16);
        mma_bf16(dv[2 * dj], pf[kk], of[0], of[1]);
        mma_bf16(dv[2 * dj + 1], pf[kk], of[2], of[3]);
        mma_bf16(dk[2 * dj], df[kk], qf[0], qf[1]);
        mma_bf16(dk[2 * dj + 1], df[kk], qf[2], qf[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = key[half];
    if (s >= S) continue;
    bf16* drow = static_cast<bf16*>(a.dqkv) + (row0 + s) * ld3 + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      store_cols2(drow + D, n * 8 + 2 * t, HD, a.vec, dk[n][half * 2], dk[n][half * 2 + 1]);
      store_cols2(drow + 2 * D, n * 8 + 2 * t, HD, a.vec, dv[n][half * 2], dv[n][half * 2 + 1]);
    }
  }
}

// ------------------------------------------------------------------ fp32

template <int FHD>
struct BwdQF32Smem {
  float Qs[F_QA][FHD];  // q, scaled
  float Os[F_QA][FHD];  // dO
  float Ks[F_T][FHD + 1];
  float Vs[F_T][FHD + 1];
  float kbias[F_T];
  float kvalid[F_T];
};

template <int FHD>
struct BwdKVF32Smem {
  float Ks[F_KB][FHD];
  float Vs[F_KB][FHD];
  float Qr[F_T][FHD + 1];  // q as it is; scaled on the fly for the logits
  float Os[F_T][FHD + 1];  // dO
  float rsum[F_T];
  float delta[F_T];
};

template <int FHD>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_q_f32(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  BwdQF32Smem<FHD>& sm = *reinterpret_cast<BwdQF32Smem<FHD>*>(smem_bwd);
  auto& Qs = sm.Qs;
  auto& Os = sm.Os;
  auto& Ks = sm.Ks;
  auto& Vs = sm.Vs;
  auto& kbias = sm.kbias;
  auto& kvalid = sm.kvalid;

  const int S = a.S, H = a.H, HD = a.HD, D = H * HD, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * F_QA;
  const size_t row0 = static_cast<size_t>(b) * S, ld3 = 3 * static_cast<size_t>(D);
  const float* x = static_cast<const float*>(a.qkv) + row0 * ld3 + h * HD;
  const float* go = static_cast<const float*>(a.g) + row0 * D + h * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int RW = F_QA / 4;  // rows per warp

  for (int c = tid; c < F_QA * HD; c += BWD_THREADS) {
    const int r = c / HD, d = c % HD, s = q0 + r;
    Qs[r][d] = s < S ? x[s * ld3 + d] * a.q_scale : 0.f;
    Os[r][d] = s < S ? go[s * D + d] : 0.f;
  }
  const int k_end = a.causal ? min(S, q0 + F_QA) : S;

  auto load_tile = [&](int k0) {
    __syncthreads();
    for (int c = tid; c < F_T * HD; c += BWD_THREADS) {
      const int r = c / HD, d = c % HD, s = k0 + r;
      Ks[r][d] = s < S ? x[s * ld3 + D + d] : 0.f;
      Vs[r][d] = s < S ? x[s * ld3 + 2 * D + d] : 0.f;
    }
    if (tid < F_T) {
      const int s = k0 + tid;
      const bool ok = s < S && a.mask[row0 + s] > 0;
      kbias[tid] = ok ? SOFTMAX_CLAMP : NEG_INF;
      kvalid[tid] = ok ? 1.f : 0.f;
    }
    __syncthreads();
  };
  auto prob = [&](int r, int k0) {  // p̃ of row r against key k0 + lane
    float l = 0.f;
    for (int d = 0; d < HD; ++d) l = fmaf(Qs[r][d], Ks[lane][d], l);
    float kbv = kbias[lane];
    if (a.causal && k0 + lane > q0 + r) kbv = NEG_INF;
    return expf(fminf(l, kbv));
  };
  auto grad_p = [&](int r) {
    float dp = 0.f;
    for (int d = 0; d < HD; ++d) dp = fmaf(Os[r][d], Vs[lane][d], dp);
    return dp;
  };

  float rs[RW], dl[RW], dq[RW][FHD / 32];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    rs[rr] = dl[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < FHD / 32; ++i) dq[rr][i] = 0.f;
  }
  for (int k0 = 0; k0 < k_end; k0 += F_T) {
    load_tile(k0);
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) rs[rr] += prob(warp * RW + rr, k0);
  }
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) rs[rr] = fmaxf(warp_sum(rs[rr]), ROWSUM_FLOOR);
  for (int k0 = 0; k0 < k_end; k0 += F_T) {
    load_tile(k0);
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      dl[rr] += (prob(r, k0) / rs[rr]) * grad_p(r);
    }
  }
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) dl[rr] = warp_sum(dl[rr]);
  for (int k0 = 0; k0 < k_end; k0 += F_T) {
    load_tile(k0);
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      const float p = prob(r, k0) / rs[rr];
      const float dp = grad_p(r);
      const float ds = (kvalid[lane] > 0.f ? p * (dp - dl[rr]) : 0.f) * a.ds_scale;
      for (int j = 0; j < F_T; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < FHD / 32; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) dq[rr][i] = fmaf(dsj, Ks[j][d], dq[rr][i]);
        }
      }
    }
  }

  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;
  const size_t n_stat = static_cast<size_t>(a.B) * H * S;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int s = q0 + warp * RW + rr;
    if (s >= S) continue;
    float* drow = static_cast<float*>(a.dqkv) + (row0 + s) * ld3 + h * HD;
#pragma unroll
    for (int i = 0; i < FHD / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) drow[d] = dq[rr][i];
    }
    if (lane == 0) {
      a.stats[stat0 + s] = rs[rr];
      a.stats[n_stat + stat0 + s] = dl[rr];
    }
  }
}

template <int FHD>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_kv_f32(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  BwdKVF32Smem<FHD>& sm = *reinterpret_cast<BwdKVF32Smem<FHD>*>(smem_bwd);
  auto& Ks = sm.Ks;
  auto& Vs = sm.Vs;
  auto& Qr = sm.Qr;
  auto& Os = sm.Os;
  auto& rsum = sm.rsum;
  auto& delta = sm.delta;

  const int S = a.S, H = a.H, HD = a.HD, D = H * HD, b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * F_KB;
  const size_t row0 = static_cast<size_t>(b) * S, ld3 = 3 * static_cast<size_t>(D);
  const float* x = static_cast<const float*>(a.qkv) + row0 * ld3 + h * HD;
  const float* go = static_cast<const float*>(a.g) + row0 * D + h * HD;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;
  const size_t n_stat = static_cast<size_t>(a.B) * H * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int RW = F_KB / 4;  // key rows per warp

  for (int c = tid; c < F_KB * HD; c += BWD_THREADS) {
    const int r = c / HD, d = c % HD, s = k0 + r;
    Ks[r][d] = s < S ? x[s * ld3 + D + d] : 0.f;
    Vs[r][d] = s < S ? x[s * ld3 + 2 * D + d] : 0.f;
  }
  float kbv[RW];
  bool kok[RW];
  float dk[RW][FHD / 32], dv[RW][FHD / 32];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int s = k0 + warp * RW + rr;
    kok[rr] = s < S && a.mask[row0 + s] > 0;
    kbv[rr] = kok[rr] ? SOFTMAX_CLAMP : NEG_INF;
#pragma unroll
    for (int i = 0; i < FHD / 32; ++i) dk[rr][i] = dv[rr][i] = 0.f;
  }

  const int q_begin = a.causal ? (k0 / F_T) * F_T : 0;
  for (int q0 = q_begin; q0 < S; q0 += F_T) {
    __syncthreads();
    for (int c = tid; c < F_T * HD; c += BWD_THREADS) {
      const int r = c / HD, d = c % HD, s = q0 + r;
      Qr[r][d] = s < S ? x[s * ld3 + d] : 0.f;
      Os[r][d] = s < S ? go[s * D + d] : 0.f;
    }
    if (tid < F_T) {
      const int s = q0 + tid;
      rsum[tid] = s < S ? a.stats[stat0 + s] : 1.f;
      delta[tid] = s < S ? a.stats[n_stat + stat0 + s] : 0.f;
    }
    __syncthreads();
    const int q = q0 + lane;  // this lane's query
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int kr = warp * RW + rr;
      float l = 0.f, dp = 0.f;
      for (int d = 0; d < HD; ++d) {
        l = fmaf(Qr[lane][d] * a.q_scale, Ks[kr][d], l);
        dp = fmaf(Os[lane][d], Vs[kr][d], dp);
      }
      float kb = kbv[rr];
      if (a.causal && k0 + kr > q) kb = NEG_INF;
      const float p = q < S ? expf(fminf(l, kb)) / rsum[lane] : 0.f;
      const float ds = (kok[rr] ? p * (dp - delta[lane]) : 0.f) * a.ds_scale;
      for (int j = 0; j < F_T; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < FHD / 32; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) {
            dv[rr][i] = fmaf(pj, Os[j][d], dv[rr][i]);
            dk[rr][i] = fmaf(dsj, Qr[j][d], dk[rr][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int s = k0 + warp * RW + rr;
    if (s >= S) continue;
    float* drow = static_cast<float*>(a.dqkv) + (row0 + s) * ld3 + h * HD;
#pragma unroll
    for (int i = 0; i < FHD / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        drow[D + d] = dk[rr][i];
        drow[2 * D + d] = dv[rr][i];
      }
    }
  }
}

// Kernel A, then kernel B; their shared memory passes the 48 KB static
// limit at a width of 128 (bf16 and fp32).
template <int HDP>
cudaError_t launch_bwd_bf16(const BwdArgs& a, cudaStream_t st) {
  constexpr size_t smem_q = sizeof(BwdQBf16Smem<HDP>), smem_kv = sizeof(BwdKVBf16Smem<HDP>);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      attn_bwd_q_bf16<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      attn_bwd_kv_bf16<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (attr_q != cudaSuccess) return attr_q;
  if (attr_kv != cudaSuccess) return attr_kv;
  attn_bwd_q_bf16<HDP><<<dim3((a.S + QA - 1) / QA, a.H, a.B), BWD_THREADS, smem_q, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_kv_bf16<HDP><<<dim3((a.S + KB - 1) / KB, a.H, a.B), BWD_THREADS, smem_kv, st>>>(a);
  return cudaSuccess;
}

template <int FHD>
cudaError_t launch_bwd_f32(const BwdArgs& a, cudaStream_t st) {
  constexpr size_t smem_q = sizeof(BwdQF32Smem<FHD>), smem_kv = sizeof(BwdKVF32Smem<FHD>);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      attn_bwd_q_f32<FHD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      attn_bwd_kv_f32<FHD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (attr_q != cudaSuccess) return attr_q;
  if (attr_kv != cudaSuccess) return attr_kv;
  attn_bwd_q_f32<FHD><<<dim3((a.S + F_QA - 1) / F_QA, a.H, a.B), BWD_THREADS, smem_q, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_kv_f32<FHD><<<dim3((a.S + F_KB - 1) / F_KB, a.H, a.B), BWD_THREADS, smem_kv, st>>>(a);
  return cudaSuccess;
}

}  // namespace k1

// qkv, dqkv: (B, S, 3·H·HD); g: (B, S, H·HD) in the same dtype; stats:
// fp32 scratch of 2·B·H·S.  Kernel A, then kernel B, on the caller's stream.
// Any head dim from 1 to 128, rounded up to the kernels' tile width (bf16:
// 16, 32, 64, 96 or 128; fp32: 32, 64, 96 or 128) with zero columns.
extern "C" int caco_attention_bwd(int dtype, const void* qkv, const int* mask, const void* g,
                                  void* dqkv, float* stats, int B, int S, int H, int HD,
                                  float q_scale, float ds_scale, int causal, void* stream) {
  using namespace k1;
  if (B <= 0 || S <= 0 || H <= 0 || HD <= 0 || HD > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dqkv)) & 15) == 0;
  const BwdArgs a{qkv, mask, g, dqkv, stats, B, S, H, HD, aligned && HD % 8 == 0,
                  q_scale, ds_scale, causal};
  cudaError_t err;
  if (dtype == BF16) {
    err = HD <= 16   ? launch_bwd_bf16<16>(a, st)
          : HD <= 32 ? launch_bwd_bf16<32>(a, st)
          : HD <= 64 ? launch_bwd_bf16<64>(a, st)
          : HD <= 96 ? launch_bwd_bf16<96>(a, st)
                     : launch_bwd_bf16<128>(a, st);
  } else if (dtype == F32) {
    err = HD <= 32   ? launch_bwd_f32<32>(a, st)
          : HD <= 64 ? launch_bwd_f32<64>(a, st)
          : HD <= 96 ? launch_bwd_f32<96>(a, st)
                     : launch_bwd_f32<128>(a, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
