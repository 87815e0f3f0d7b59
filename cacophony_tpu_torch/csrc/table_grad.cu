// The gradient of a gather from a table of a few rows: the rows of g (N, D)
// summed into the table row each index names, in fp32 → (n_rows, D).
//
// Replaces no Pallas kernel.  The audio encoder and the MAE decoder add a
// learned frequency embedding gathered from an 8-row table to every patch
// (models/audio.py:_add_positions), so the backward folds 64 000 rows of a
// caco_base step into 8.  PyTorch's `index_put_(accumulate=True)` sorts the
// indices and walks each index's duplicates one after another in a few
// blocks, in the gradient's dtype; this kernel sums in fp32 on every SM.
//
// Bound on the card: memory — one read of g (N·D·2 bytes in bf16: 98.3 MB,
// 29 µs at caco_base's 64 000 × 768), against one add an element.
//  - Pass 1 (`table_grad_partial`): one wave of CTAs, each over a contiguous
//    slice of the rows.  A thread owns fixed columns of the table and reads
//    them with 16-byte loads, UNROLL rows in flight, so a column belongs to
//    one thread of the CTA and its fp32 accumulator in shared memory
//    (n_rows × D, at most 48 KB) needs no atomics.  The accumulator keeps
//    element j of a thread's vector at j·(D / VEC) + its column, so a warp
//    adding element j touches 32 consecutive words (no bank conflict).
//    Each CTA writes its partial sum (n_cta, n_rows, D).
//  - Pass 2 (`table_grad_reduce`): the partials summed over n_cta in a fixed
//    order (8 strided runs a column, then the 8 runs in order).
// No atomics anywhere, and the grid depends only on N and the card's SM
// count, so a call gives the same bits every time.  Rows whose index lies
// outside [0, n_rows) add nothing (the forward's gather refuses them).
#include <algorithm>

#include "k1_common.cuh"

namespace tg {

using k1::bf16;

constexpr int UNROLL = 8;          // rows a thread has in flight
constexpr int RED_COLS = 32;       // pass 2: table elements a block
constexpr int RED_SPLITS = 8;      // pass 2: runs over the partials a column
constexpr int MAX_THREADS = 1024;

template <typename T, int VEC>
struct Row;  // VEC consecutive elements of a row, as one load

template <>
struct Row<bf16, 8> {
  uint4 v;
  __device__ __forceinline__ void load(const bf16* p) { v = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ float at(int j) const {
    return __bfloat162float(reinterpret_cast<const bf16*>(&v)[j]);
  }
};

template <>
struct Row<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ float at(int j) const { return reinterpret_cast<const float*>(&v)[j]; }
};

template <typename T>
struct Row<T, 1> {
  float v;
  __device__ __forceinline__ void load(const T* p) { v = k1::to_f(*p); }
  __device__ __forceinline__ float at(int) const { return v; }
};

template <typename T, typename I, int VEC>
__global__ void table_grad_partial(const T* __restrict__ g, const I* __restrict__ inds, int n,
                                   int width, int n_rows, int rows_per_cta,
                                   float* __restrict__ partial) {
  extern __shared__ float acc[];  // [n_rows][VEC][width / VEC]
  const int size = n_rows * width, vcols = width / VEC;
  for (int i = threadIdx.x; i < size; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int lo = blockIdx.x * rows_per_cta;
  const int hi = min(n, lo + rows_per_cta);
  for (int vc = threadIdx.x; vc < vcols; vc += blockDim.x) {
    const T* col = g + static_cast<size_t>(vc) * VEC;
    for (int r0 = lo; r0 < hi; r0 += UNROLL) {
      Row<T, VEC> v[UNROLL];
      int row[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = r0 + u;
        row[u] = -1;
        if (r < hi) {
          v[u].load(col + static_cast<size_t>(r) * width);
          const long long t = static_cast<long long>(inds[r]);
          if (t >= 0 && t < n_rows) row[u] = static_cast<int>(t);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (row[u] < 0) continue;
        float* a = acc + row[u] * width + vc;
#pragma unroll
        for (int j = 0; j < VEC; ++j) a[j * vcols] += v[u].at(j);
      }
    }
  }
  __syncthreads();

  float* out = partial + static_cast<size_t>(blockIdx.x) * size;
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const int r = i / width, c = i % width;
    out[i] = acc[r * width + (c % VEC) * vcols + c / VEC];
  }
}

__global__ void __launch_bounds__(RED_COLS * RED_SPLITS)
    table_grad_reduce(const float* __restrict__ partial, int n_cta, int size,
                      float* __restrict__ out) {
  __shared__ float runs[RED_SPLITS][RED_COLS];
  const int lane = threadIdx.x % RED_COLS, split = threadIdx.x / RED_COLS;
  const int i = blockIdx.x * RED_COLS + lane;
  float s = 0.f;
  if (i < size) {
#pragma unroll 4
    for (int c = split; c < n_cta; c += RED_SPLITS) s += partial[static_cast<size_t>(c) * size + i];
  }
  runs[split][lane] = s;
  __syncthreads();
  if (split == 0 && i < size) {
    float t = runs[0][lane];
#pragma unroll
    for (int k = 1; k < RED_SPLITS; ++k) t += runs[k][lane];
    out[i] = t;
  }
}

template <typename T, typename I, int VEC>
void launch_partial(const void* g, const void* inds, int n, int width, int n_rows, int n_cta,
                    float* partial, cudaStream_t s) {
  const int vcols = width / VEC;
  const int threads = std::min(MAX_THREADS, (vcols + 31) / 32 * 32);
  const int rows_per_cta = (n + n_cta - 1) / n_cta;
  const size_t smem = static_cast<size_t>(n_rows) * width * sizeof(float);
  table_grad_partial<T, I, VEC><<<n_cta, threads, smem, s>>>(
      static_cast<const T*>(g), static_cast<const I*>(inds), n, width, n_rows, rows_per_cta,
      partial);
}

// 16-byte loads where the row width and the base allow them, else one
// element at a time.
template <typename T, typename I>
void launch_partial_vec(const void* g, const void* inds, int n, int width, int n_rows, int n_cta,
                        float* partial, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (width % VEC == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0)
    launch_partial<T, I, VEC>(g, inds, n, width, n_rows, n_cta, partial, s);
  else
    launch_partial<T, I, 1>(g, inds, n, width, n_rows, n_cta, partial, s);
}

template <typename T>
void launch_partial_index(int index_bits, const void* g, const void* inds, int n, int width,
                          int n_rows, int n_cta, float* partial, cudaStream_t s) {
  if (index_bits == 64)
    launch_partial_vec<T, long long>(g, inds, n, width, n_rows, n_cta, partial, s);
  else
    launch_partial_vec<T, int>(g, inds, n, width, n_rows, n_cta, partial, s);
}

}  // namespace tg

// g (n, width) bf16 or fp32 and inds (n,) int32 or int64 (index_bits 32 or
// 64) → out (n_rows, width) fp32, through the scratch `partial` (n_cta,
// n_rows, width) fp32.  n_rows · width · 4 bytes fit 48 KB of shared memory
// (ops/_kernels.py:TABLE_GRAD_MAX_FLOATS); n_cta ≥ 1.
extern "C" int table_grad(int dtype, int index_bits, const void* g, const void* inds, int n,
                          int width, int n_rows, int n_cta, float* partial, float* out,
                          void* stream) {
  using namespace tg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((index_bits != 32 && index_bits != 64) || n < 0 || width < 1 || n_rows < 1 || n_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == k1::BF16)
    launch_partial_index<bf16>(index_bits, g, inds, n, width, n_rows, n_cta, partial, s);
  else if (dtype == k1::F32)
    launch_partial_index<float>(index_bits, g, inds, n, width, n_rows, n_cta, partial, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = n_rows * width;
  table_grad_reduce<<<(size + RED_COLS - 1) / RED_COLS, RED_COLS * RED_SPLITS, 0, s>>>(
      partial, n_cta, size, out);
  return static_cast<int>(cudaGetLastError());
}
