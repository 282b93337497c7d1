// GAT's edge softmax, its backward and the rewrite of the attention weights
// into the tile copies, for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package has no GAT.  These are the card's
// path of repro_torch.kernels.autodiff._Attention (the port's GAT,
// graph/layers_gnn.py), in place of a chain of torch segment passes whose
// amax and sums were atomics on the card.  For a CSR matrix A (row =
// destination), every stored entry e = (i, j) and every head h < heads:
//   score[e, h] = s_dst[i, h] + s_src[j, h]
//   alpha[e, h] = exp(lrelu(score) - m[i, h]) / sum over row i of the same,
//                 m[i, h] the row's maximum of lrelu(score)
// with lrelu(v) = v > 0 ? v : slope * v.  The four launchers:
//   hbp_softmax_forward_launch  writes alpha [nnz, heads] in CSR order;
//   hbp_softmax_backward_launch reads alpha and its gradient d_alpha and
//     writes de[e, h] = alpha (d_alpha - sum over row i of alpha d_alpha),
//     times slope where score <= 0, in CSR order, and d_dst[i, h] = the
//     row's sum of de;
//   hbp_softmax_columns_launch  walks A^T's CSR order (A^T's position p
//     holds A's entry perm_T[p]) and writes d_src[j, h] = the sum of de over
//     column j;
//   hbp_rewrite_launch          writes heads copies of a tile set's values,
//     data[h, s] = values[entry[s], h], 0 where entry[s] < 0 (a padded
//     slot): alpha into A's tiles (entry: A's entry at each slot) and into
//     A^T's (entry: A's entry at each slot of A^T's tiles).
// Their plain versions are repro_torch.kernels.ref.edge_softmax,
// edge_softmax_backward, edge_softmax_columns and rewritten_values.
//
// Design.
// * A row's entries are walked by a warp, or by the whole block where the
//   row is long.  The caller hands each launch its rows in an order
//   (walk, from admission): the first n_long rows, those above the long-row
//   length, take a block each (blocks 0 .. n_long - 1), the rest a warp
//   each (the following blocks, blockDim / 32 rows a block).  R-MAT's hub
//   rows hold thousands of entries beside a median of a few, so a warp a
//   row would leave a few warps walking hubs after the rest had finished;
//   admission sorts the rows longest first, so the hubs start first and
//   the warps of one block walk rows of like length.  The wrappers launch
//   blocks of 512 threads and give a block each row above 512 entries
//   (hbp_spmv.SOFTMAX_THREADS and SOFTMAX_LONG_ROW), the fastest of the
//   geometries scripts/time_softmax.py times on the kron16 graph (PERF.md).
// * The reductions over a row (its maximum, its sums) stay in registers:
//   each thread folds the entries it walks in entry order, then a butterfly
//   of __shfl_xor_sync combines a warp's lanes (every lane ends with the
//   same bits, addition being commutative), and in a block the warps'
//   results are combined in warp order through shared memory.  No atomics:
//   the same inputs give the same bits on every launch.
// * The heads are a template argument (1 to 8), so a thread keeps one
//   accumulator a head in registers and gathers an entry's heads together
//   (heads contiguous floats of s_src, alpha, d_alpha, de).
// * The tile copies are written by a pass of their own in the tiles' order,
//   a thread a slot: every sector of the copies is written whole, padding
//   included, so no zero fill comes first, and the values are read in
//   runs (a tile row's lanes hold consecutive entries of one row of the
//   tiled matrix).  Written from the row walks, at each entry's slot, every
//   4-byte write landed in a sector of its own, which the card read back
//   from memory first: 0.05 ms more for A's copies and 0.19 ms for A^T's
//   on the kron16 graph at 3 heads (PERF.md).
// * float32 throughout, expf (not __expf), each product and sum rounded on
//   its own (__fmul_rn, __fadd_rn, __fsub_rn: no fused multiply-add), as the
//   plain versions compute; only the order of the sums differs.
//
// Bound on this card: bytes.  The work model (h100bench/work/gat.py,
// softmax()) counts the CSR structure and the score tables read once and
// alpha written once forward, alpha and d_alpha read and the score
// gradients written backward: about 0.07 and 0.12 GB a layer of GAT on the
// kron16 graph (~0.02 and 0.04 ms at 3.35 TB/s).  The kernels move more:
// the tile copies (padding included) and their entry maps, de gathered
// again through perm_T, and a row's s_src gathers and column indices read
// once in each of the forward's three passes (from L1 or L2 after the
// first).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kRewriteThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

// The row's walkers: a warp (kBlock false) or the whole block.  reduce()
// leaves every walker holding the group's total of each head, combined in
// a fixed order.
template <bool kBlock, int kHeads>
struct Walkers {
  float (*shared)[kMaxThreads / kWarp];  // [kHeads][warps], used by a block

  __device__ int rank() const { return kBlock ? threadIdx.x : threadIdx.x % kWarp; }
  __device__ int size() const { return kBlock ? blockDim.x : kWarp; }

  template <bool kMax>
  __device__ void reduce(float (&v)[kHeads]) const {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) v[h] = kMax ? warp_max(v[h]) : warp_sum(v[h]);
    if (!kBlock) return;
    const int warp = threadIdx.x / kWarp, warps = blockDim.x / kWarp;
    __syncthreads();  // every walker has read the previous reduction's values
    if (threadIdx.x % kWarp == 0) {
#pragma unroll
      for (int h = 0; h < kHeads; ++h) shared[h][warp] = v[h];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      float acc = shared[h][0];
      for (int w = 1; w < warps; ++w)
        acc = kMax ? fmaxf(acc, shared[h][w]) : __fadd_rn(acc, shared[h][w]);
      v[h] = acc;
    }
  }
};

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.0f ? v : __fmul_rn(slope, v);
}

template <bool kBlock, int kHeads>
__device__ void forward_row(const Walkers<kBlock, kHeads>& g, int row,
                            const long long* __restrict__ indptr, const int* __restrict__ cols,
                            const float* __restrict__ s_src, const float* __restrict__ s_dst,
                            float* __restrict__ alpha, float slope) {
  const int64_t begin = __ldg(indptr + row), end = __ldg(indptr + row + 1);
  const int64_t step = g.size();
  float dst[kHeads], top[kHeads], total[kHeads];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    dst[h] = __ldg(s_dst + static_cast<int64_t>(row) * kHeads + h);
    top[h] = -CUDART_INF_F;
    total[h] = 0.0f;
  }
#pragma unroll 4
  for (int64_t e = begin + g.rank(); e < end; e += step) {
    const float* src = s_src + static_cast<int64_t>(__ldg(cols + e)) * kHeads;
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
      top[h] = fmaxf(top[h], leaky(__fadd_rn(dst[h], __ldg(src + h)), slope));
  }
  g.template reduce<true>(top);
#pragma unroll 4
  for (int64_t e = begin + g.rank(); e < end; e += step) {
    const float* src = s_src + static_cast<int64_t>(__ldg(cols + e)) * kHeads;
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
      total[h] = __fadd_rn(
          total[h], expf(__fsub_rn(leaky(__fadd_rn(dst[h], __ldg(src + h)), slope), top[h])));
  }
  g.template reduce<false>(total);
#pragma unroll 4
  for (int64_t e = begin + g.rank(); e < end; e += step) {
    const float* src = s_src + static_cast<int64_t>(__ldg(cols + e)) * kHeads;
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
      alpha[e * kHeads + h] = __fdiv_rn(
          expf(__fsub_rn(leaky(__fadd_rn(dst[h], __ldg(src + h)), slope), top[h])), total[h]);
  }
}

template <bool kBlock, int kHeads>
__device__ void backward_row(const Walkers<kBlock, kHeads>& g, int row,
                             const long long* __restrict__ indptr, const int* __restrict__ cols,
                             const float* __restrict__ s_src, const float* __restrict__ s_dst,
                             const float* __restrict__ alpha, const float* __restrict__ d_alpha,
                             float* __restrict__ de, float* __restrict__ d_dst, float slope) {
  const int64_t begin = __ldg(indptr + row), end = __ldg(indptr + row + 1);
  const int64_t step = g.size();
  float dst[kHeads], weighted[kHeads], total[kHeads];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    dst[h] = __ldg(s_dst + static_cast<int64_t>(row) * kHeads + h);
    weighted[h] = 0.0f;
    total[h] = 0.0f;
  }
#pragma unroll 4
  for (int64_t e = begin + g.rank(); e < end; e += step) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
      weighted[h] = __fadd_rn(weighted[h], __fmul_rn(__ldg(alpha + e * kHeads + h),
                                                     __ldg(d_alpha + e * kHeads + h)));
  }
  g.template reduce<false>(weighted);
#pragma unroll 4
  for (int64_t e = begin + g.rank(); e < end; e += step) {
    const float* src = s_src + static_cast<int64_t>(__ldg(cols + e)) * kHeads;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      float d = __fmul_rn(__ldg(alpha + e * kHeads + h),
                          __fsub_rn(__ldg(d_alpha + e * kHeads + h), weighted[h]));
      if (!(__fadd_rn(dst[h], __ldg(src + h)) > 0.0f)) d = __fmul_rn(slope, d);
      de[e * kHeads + h] = d;
      total[h] = __fadd_rn(total[h], d);
    }
  }
  g.template reduce<false>(total);
  if (g.rank() == 0) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) d_dst[static_cast<int64_t>(row) * kHeads + h] = total[h];
  }
}

template <bool kBlock, int kHeads>
__device__ void column_row(const Walkers<kBlock, kHeads>& g, int col,
                           const long long* __restrict__ indptr_T, const int* __restrict__ perm_T,
                           const float* __restrict__ de, float* __restrict__ d_src) {
  const int64_t begin = __ldg(indptr_T + col), end = __ldg(indptr_T + col + 1);
  const int64_t step = g.size();
  float total[kHeads];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) total[h] = 0.0f;
#pragma unroll 4
  for (int64_t p = begin + g.rank(); p < end; p += step) {
    const float* d = de + static_cast<int64_t>(__ldg(perm_T + p)) * kHeads;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) total[h] = __fadd_rn(total[h], __ldg(d + h));
  }
  g.template reduce<false>(total);
  if (g.rank() == 0) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) d_src[static_cast<int64_t>(col) * kHeads + h] = total[h];
  }
}

// Runs body(walkers, row) for this block's row (blockIdx.x < n_long) or
// this warp's; whole warps leave together, so the shuffles see all 32.
template <int kHeads, class Body>
__device__ __forceinline__ void walk_rows(const int* __restrict__ walk, int n_rows, int n_long,
                                          Body body) {
  __shared__ float shared[kHeads][kMaxThreads / kWarp];
  if (static_cast<int>(blockIdx.x) < n_long) {
    body(Walkers<true, kHeads>{shared}, __ldg(walk + blockIdx.x));
    return;
  }
  const int64_t w = static_cast<int64_t>(blockIdx.x - n_long) * (blockDim.x / kWarp) +
                    threadIdx.x / kWarp;
  if (n_long + w >= n_rows) return;
  body(Walkers<false, kHeads>{shared}, __ldg(walk + n_long + w));
}

template <int kHeads>
__global__ void __launch_bounds__(kMaxThreads) softmax_forward_kernel(
    const long long* __restrict__ indptr, const int* __restrict__ cols,
    const int* __restrict__ walk, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, float* __restrict__ alpha, int n_rows, int n_long,
    float slope) {
  walk_rows<kHeads>(walk, n_rows, n_long, [&](const auto& g, int row) {
    forward_row(g, row, indptr, cols, s_src, s_dst, alpha, slope);
  });
}

template <int kHeads>
__global__ void __launch_bounds__(kMaxThreads) softmax_backward_kernel(
    const long long* __restrict__ indptr, const int* __restrict__ cols,
    const int* __restrict__ walk, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, const float* __restrict__ alpha,
    const float* __restrict__ d_alpha, float* __restrict__ de, float* __restrict__ d_dst,
    int n_rows, int n_long, float slope) {
  walk_rows<kHeads>(walk, n_rows, n_long, [&](const auto& g, int row) {
    backward_row(g, row, indptr, cols, s_src, s_dst, alpha, d_alpha, de, d_dst, slope);
  });
}

template <int kHeads>
__global__ void __launch_bounds__(kMaxThreads) softmax_columns_kernel(
    const long long* __restrict__ indptr_T, const int* __restrict__ perm_T,
    const int* __restrict__ walk_T, const float* __restrict__ de, float* __restrict__ d_src,
    int n_cols, int n_long) {
  walk_rows<kHeads>(walk_T, n_cols, n_long, [&](const auto& g, int col) {
    column_row(g, col, indptr_T, perm_T, de, d_src);
  });
}

// A thread a slot, the heads' copies written one after another: each warp
// writes whole sectors of each copy.
template <int kHeads>
__global__ void __launch_bounds__(kRewriteThreads) rewrite_kernel(
    const int* __restrict__ entry, const float* __restrict__ values, float* __restrict__ data,
    long long n_slots) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kRewriteThreads + threadIdx.x;
  if (s >= n_slots) return;
  const int e = __ldg(entry + s);
  const float* v = values + static_cast<int64_t>(e) * kHeads;
#pragma unroll
  for (int h = 0; h < kHeads; ++h) data[h * n_slots + s] = e >= 0 ? __ldg(v + h) : 0.0f;
}

// The grid of a walk: a block for each of the n_long rows, then a warp for
// each of the rest; 0 where the arguments are out of range.
int64_t grid_of(int n_rows, int n_long, int threads) {
  if (n_rows <= 0 || n_long < 0 || n_long > n_rows || threads < kWarp ||
      threads > kMaxThreads || threads % kWarp)
    return 0;
  const int warps = threads / kWarp;
  const int64_t blocks = n_long + (static_cast<int64_t>(n_rows - n_long) + warps - 1) / warps;
  return blocks > 0x7fffffffLL ? 0 : blocks;
}

}  // namespace

// One case of the heads' switch of each launcher (1 to 8, hbp_spmv.SOFTMAX_MAX_HEADS).
#define HBP_SOFTMAX_HEADS(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)

extern "C" {

// indptr: i64[n_rows + 1] (long long, which __ldg takes); cols: i32[nnz];
// walk: i32[n_rows], every row once, the n_long rows walked by a block
// first; s_src: f32[n_cols, heads]; s_dst: f32[n_rows, heads]; alpha:
// f32[nnz, heads] (every element written).  threads: a block's threads, a
// multiple of 32 up to 1024.
int hbp_softmax_forward_launch(const long long* indptr, const int* cols, const int* walk,
                               const float* s_src, const float* s_dst, float* alpha, int n_rows,
                               int n_long, int heads, float slope, int threads, int device,
                               void* stream) {
  const int64_t blocks = grid_of(n_rows, n_long, threads);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (heads) {
#define HBP_CASE(H)                                                            \
  case H:                                                                      \
    softmax_forward_kernel<H><<<static_cast<unsigned>(blocks), threads, 0,     \
                                static_cast<cudaStream_t>(stream)>>>(          \
        indptr, cols, walk, s_src, s_dst, alpha, n_rows, n_long, slope);       \
    break;
    HBP_SOFTMAX_HEADS(HBP_CASE)
#undef HBP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// As the forward, with alpha and d_alpha: f32[nnz, heads] read; de:
// f32[nnz, heads] and d_dst: f32[n_rows, heads] (every element written).
int hbp_softmax_backward_launch(const long long* indptr, const int* cols, const int* walk,
                                const float* s_src, const float* s_dst, const float* alpha,
                                const float* d_alpha, float* de, float* d_dst, int n_rows,
                                int n_long, int heads, float slope, int threads, int device,
                                void* stream) {
  const int64_t blocks = grid_of(n_rows, n_long, threads);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (heads) {
#define HBP_CASE(H)                                                                    \
  case H:                                                                              \
    softmax_backward_kernel<H><<<static_cast<unsigned>(blocks), threads, 0,            \
                                 static_cast<cudaStream_t>(stream)>>>(                 \
        indptr, cols, walk, s_src, s_dst, alpha, d_alpha, de, d_dst, n_rows, n_long, slope); \
    break;
    HBP_SOFTMAX_HEADS(HBP_CASE)
#undef HBP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// indptr_T: i64[n_cols + 1], A^T's rows; perm_T: i32[nnz], A's entry at
// each of A^T's positions; walk_T: i32[n_cols] as the forward's walk, over
// A^T's rows; de: f32[nnz, heads] in A's order; d_src: f32[n_cols, heads]
// (every element written).
int hbp_softmax_columns_launch(const long long* indptr_T, const int* perm_T, const int* walk_T,
                               const float* de, float* d_src, int n_cols, int n_long, int heads,
                               int threads, int device, void* stream) {
  const int64_t blocks = grid_of(n_cols, n_long, threads);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (heads) {
#define HBP_CASE(H)                                                          \
  case H:                                                                    \
    softmax_columns_kernel<H><<<static_cast<unsigned>(blocks), threads, 0,   \
                                static_cast<cudaStream_t>(stream)>>>(        \
        indptr_T, perm_T, walk_T, de, d_src, n_cols, n_long);                \
    break;
    HBP_SOFTMAX_HEADS(HBP_CASE)
#undef HBP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// entry: i32[n_slots], each below values' rows or -1; values: f32[rows,
// heads]; data: f32[heads, n_slots] (every element written).
int hbp_rewrite_launch(const int* entry, const float* values, float* data, long long n_slots,
                       int heads, int device, void* stream) {
  const long long blocks = (n_slots + kRewriteThreads - 1) / kRewriteThreads;
  if (n_slots <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (heads) {
#define HBP_CASE(H)                                                                   \
  case H:                                                                             \
    rewrite_kernel<H><<<static_cast<unsigned>(blocks), kRewriteThreads, 0,            \
                        static_cast<cudaStream_t>(stream)>>>(entry, values, data, n_slots); \
    break;
    HBP_SOFTMAX_HEADS(HBP_CASE)
#undef HBP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#undef HBP_SOFTMAX_HEADS
