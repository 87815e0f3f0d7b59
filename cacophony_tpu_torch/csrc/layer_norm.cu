// K1 part (a): row LayerNorm, fp32 statistics, output in the compute dtype.
//
// Replaces `_ln_rows` inside `_fused_block_kernel`
// (cacophony_tpu/ops/encoder_attention.py:491 and :548, :559): LN1 on the
// layer input and LN2 on the bf16-cast residual y.  Numerics follow it:
// mean, then the mean of squared deviations (two passes, fp32), rsqrt(var +
// eps), (x - mean) * r * scale + bias in fp32, one cast at the end.
//
// Bound on the card: memory — one read of the row per pass (the second and
// third come from L1/L2) and one write, against ~5 flops per element.  One
// warp per row keeps the reductions in registers (__shfl_xor) with no
// shared memory and no block-wide barrier.
#include "k1_common.cuh"

namespace k1 {

constexpr int LN_THREADS = 256;  // 8 rows per block, one warp each

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
    layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out, int rows, int cols,
                      float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * cols;
  T* yr = out + static_cast<size_t>(row) * cols;

  float sum = 0.f;
  for (int c = lane; c < cols; c += 32) sum += to_f(xr[c]);
  const float mean = warp_sum(sum) / cols;

  float sq = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f(xr[c]) - mean;
    sq += d * d;
  }
  const float r = rsqrtf(warp_sum(sq) / cols + eps);

  for (int c = lane; c < cols; c += 32)
    yr[c] = from_f<T>((to_f(xr[c]) - mean) * r * scale[c] + bias[c]);
}

}  // namespace k1

extern "C" int k1_layer_norm(int dtype, const void* x, const float* scale, const float* bias,
                             void* out, int rows, int cols, float eps, void* stream) {
  using namespace k1;
  const dim3 grid((rows + LN_THREADS / 32 - 1) / (LN_THREADS / 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    layer_norm_kernel<bf16><<<grid, LN_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), scale, bias, static_cast<bf16*>(out), rows, cols, eps);
  } else if (dtype == F32) {
    layer_norm_kernel<float><<<grid, LN_THREADS, 0, s>>>(
        static_cast<const float*>(x), scale, bias, static_cast<float*>(out), rows, cols, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
