// Shared helpers for the K1 encoder-layer kernels (sm_90a).
//
// K1 is the whole-layer Pallas kernel `_fused_block_kernel` with
// with_mlp=True (cacophony_tpu/ops/encoder_attention.py:514, pallas_call at
// :662).  On the TPU one grid step holds a whole (S, D) row block plus all
// four weight matrices in VMEM.  On Hopper a block has at most 227 KB of
// shared memory and one 768x3072 bf16 weight is 4.7 MB, so the layer is a
// chain of hand-written kernels (layer_norm.cu, gemm.cu, attention.cu) that
// meet in device memory; ops/encoder_attention.py drives the chain.
//
// Every entry point has a plain C interface (loaded with ctypes), launches
// on the caller's stream, allocates nothing and returns cudaGetLastError()
// right after the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace k1 {

typedef __nv_bfloat16 bf16;

// dtype codes shared with ops/_kernels.py
enum DType { F32 = 0, BF16 = 1 };

// GEMM epilogues, in the order of the layer (ops/_kernels.py mirrors them):
//   EPI_BIAS           out = T(acc + b)                    QKV projection
//   EPI_BIAS_RESID_F32 out = T(acc + b + f32(r))           o-proj + residual
//   EPI_BIAS_SILU      out = T(silu_f32(acc + b))          MLP up
//   EPI_BIAS_CAST_ADD  out = T(f32(T(acc + b)) + f32(r))   MLP down + residual
enum Epilogue {
  EPI_BIAS = 0,
  EPI_BIAS_RESID_F32 = 1,
  EPI_BIAS_SILU = 2,
  EPI_BIAS_CAST_ADD = 3
};

// The Pallas attention's softmax constants (encoder_attention.py:53, :75,
// :194), shared by the forward (attention.cu) and the backward
// (attention_bwd.cu).
constexpr float SOFTMAX_CLAMP = 80.0f;
constexpr float NEG_INF = -1e30f;
constexpr float VSCALE = 5.9604644775390625e-08f;  // 2^-24
constexpr float INV_VSCALE = 16777216.0f;          // 2^24
constexpr float ROWSUM_FLOOR = 1e-37f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

template <int EPI, typename T>
__device__ __forceinline__ T apply_epilogue(float acc, float bias, const T* resid, size_t idx) {
  float h = acc + bias;
  if constexpr (EPI == EPI_BIAS) {
    return from_f<T>(h);
  } else if constexpr (EPI == EPI_BIAS_RESID_F32) {
    return from_f<T>(h + to_f(resid[idx]));
  } else if constexpr (EPI == EPI_BIAS_SILU) {
    return from_f<T>(h * (1.0f / (1.0f + expf(-h))));
  } else {
    return from_f<T>(to_f(from_f<T>(h)) + to_f(resid[idx]));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the 4 lanes of a quad (the lanes that hold one mma.sync row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- PTX wrappers: ldmatrix, mma.sync (bf16 in, fp32 accumulate)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// D = A(16x16, row) * B(16x8, col) + D
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// mma.sync operand fragments from a row-major bf16 tile in shared memory
// (leading dimension ld, in elements), for m16n8k16:
//  - frag_a: the A fragment of rows m0..m0+15, columns k0..k0+15;
//  - frag_b_nk: B fragments when the tile's rows are B's n index and its
//    columns the k index (K for Q·Kᵀ): b[0..1] cover n0..n0+7, b[2..3]
//    n0+8..n0+15, both at k0..k0+15;
//  - frag_b_kn: the same when the rows are k and the columns n (V for P·V).
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const bf16* t, int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, t + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

__device__ __forceinline__ void frag_b_nk(unsigned (&b)[4], const bf16* t, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void frag_b_kn(unsigned (&b)[4], const bf16* t, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// Accumulators of a 16 x (8·N) tile → A fragments of the 16 x (8·N) bf16
// operand of the next product (k = the accumulators' columns): the
// accumulator of n-tile n holds rows g, g+8 at columns 8n + 2t, 2t+1.
template <int N>
__device__ __forceinline__ void acc_to_a(unsigned (&a)[N / 2][4], const float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n >> 1][(n & 1) * 2] = pack_bf16x2(acc[n][0], acc[n][1]);
    a[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(acc[n][2], acc[n][3]);
  }
}

// 16-byte copy of eight bf16 values from global memory, zeros when !pred.
__device__ __forceinline__ uint4 load8(const bf16* p, bool pred) {
  return pred ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// Columns c..c+7 of a bf16 head row of width hd, zeros past hd (and all
// zeros when !ok): one 16-byte load when `vec` (hd and the row strides
// multiples of 8, 16-byte aligned bases), else element by element.  Rounds
// any head dim up to the kernels' tile width with exact zero columns.
__device__ __forceinline__ uint4 load_cols8(const bf16* row, int c, int hd, bool vec, bool ok) {
  if (!ok || c >= hd) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return *reinterpret_cast<const uint4*>(row + c);
  uint4 r;
  bf16* e = reinterpret_cast<bf16*>(&r);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = c + j < hd ? row[c + j] : __float2bfloat16_rn(0.f);
  return r;
}

// Columns c, c+1 (c even) of a bf16 head row of width hd: the columns
// below hd, as one 4-byte store when `vec` (then hd is even).
__device__ __forceinline__ void store_cols2(bf16* row, int c, int hd, bool vec, float v0, float v1) {
  if (vec) {
    if (c < hd) *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (c < hd) row[c] = __float2bfloat16_rn(v0);
  if (c + 1 < hd) row[c + 1] = __float2bfloat16_rn(v1);
}

// ---- cp.async (sm_80+): global → shared without registers; `bytes` below
// the copy size zero-fills the rest (0: a zero tile past the edge).

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace k1
