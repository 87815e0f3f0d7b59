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

// ---- PTX wrappers: cp.async, ldmatrix, mma.sync (bf16 in, fp32 accumulate)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when pred is false.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

}  // namespace k1
