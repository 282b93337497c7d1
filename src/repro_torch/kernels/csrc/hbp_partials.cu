// Two-phase (partials) HBP SpMV and SpMM for Hopper (sm_90a), plain C
// interface: the paper's SpMV part, one partial block per tile.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/hbp_spmv.py:
//   hbp_spmv_partials_launch      <- _partials_kernel / hbp_spmv_partials
//   hbp_spmm_partials_launch      <- _partials_spmm_kernel / hbp_spmm_partials
//   hbp_spmm_partials_max_launch  <- _partials_spmm_max_kernel / hbp_spmm_partials_max
// Each computes, for every tile t, row g of its group and column c,
//   partial[t, g, c] = (+ or max) over lanes l = 0 .. lane-1 (in order)
//                      of data[t, g, l] * x[colblock[t] * col_block + cols[t, g, l], c]
// with x row-major [n_x, k] (k = 1 for SpMV) and partial row-major
// [n_tiles, group, k]; the max monoid masks slots whose stored value is 0
// and leaves -inf where a tile row has no live slot (hbp_chain.cuh).  The
// combine part (a deterministic segment sum or max over each row group's
// run of tiles) is the caller's.  Every element of the partials buffer is
// written: the caller allocates it uninitialised.
//
// Bound on this card: bytes.  The tile stream and x are read once and the
// partials buffer, n_tiles * group * k * 4 bytes, is written once; at
// k = 128 on m4_kron16 the buffer is 731 MB of the 856.  It is the price
// of the split, which the fused kernels keep out of memory.
//
// Design of the sum kernels (SpMV and SpMM): a tile's x rows gathered by
// the warps of one block.
// * A thread owns `width` columns of `rows` consecutive rows of one tile:
//   width 4 (one float4 of each x row it gathers, float4 stores) when k is
//   a multiple of 4 and x is 16-byte aligned, else width 1, the scalar-
//   column path.  The threads of a tile cover `slab` column units of all
//   its rows; slabs of wider k are the grid's second dimension.  The
//   wrapper picks the geometry (hbp_spmv.py partials_geometry): a tile
//   gets up to 64 threads, all in one block.  At k = 128 that is two warps
//   of 32 column quads, each warp 4 of the tile's 8 rows; at k <= 32 one
//   row per thread (k = 1: four tiles per warp).  On m4_kron16 (H100 SXM,
//   700 W; scripts/time_fused.py --geometry-sweep, PERF.md) two warps per
//   tile beat one (8 rows a thread) and four by 7-17 %, and 4 columns a
//   thread beat 8.  So a tile's x rows are gathered on one SM: the slots
//   that repeat a row (most are padded slots, column 0) hit L1 rather
//   than L2, and a gather moves a whole 16-byte column quad.
// * Tile rows are read as 16-byte vectors (int4 cols, float4 data) for
//   lanes 8..128; the threads of a row block read the same addresses, so
//   a load is a broadcast, not one fetch per thread.  Lane 12 and other
//   widths read scalars.
// * Each accumulator is one __fmaf_rn chain over its row's lanes in
//   order, from 0.0f: a thread's rows and columns are independent chains,
//   so neither the geometry nor the path changes a bit, SpMV is bitwise
//   column c of the SpMM whenever X[:, c] = x, and padded slots stay in
//   the chain (0 * x[col 0], as on the TPU).
// * The partials are written with streaming stores (__stcs), so the
//   buffer does not evict x from the 50 MB L2 (plain stores: 0.62 ms
//   against 0.47 at k = 128 on m4_kron16, PERF.md).
// * Offsets into x and the buffer are 64-bit (T * group * k * 4 passes
//   2^31 bytes at k = 256 on m4_kron16); per-thread index math is 32-bit.
//
// The max kernel (kernel 4) keeps the one-thread-per-(t, g, c) design of
// its first port, with the chain of hbp_chain.cuh.

#include "hbp_chain.cuh"

namespace {

using hbp::kStep;  // lanes per step of a tile row: two int4 and two float4
using hbp::kThreads;

// The thread's W columns of one x row: W = 1, or W = 4 read as a float4.
template <int W>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, float (&v)[W]) {
  static_assert(W == 1 || W == 4, "a thread owns 1 or 4 columns");
  if constexpr (W == 1) {
    v[0] = __ldg(p);
  } else {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

template <int W>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[W]) {
  if constexpr (W == 1) {
    __stcs(p, v[0]);
  } else {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
}

// One slot of one row: acc[w] = fma(d, x[col, c0 + w], acc[w]), xs
// pointing at column c0 of the tile's x segment.
template <int W>
__device__ __forceinline__ void slot(float (&acc)[W], float d, const float* __restrict__ xs,
                                     int col, int64_t k) {
  float v[W];
  load_cols<W>(xs + col * k, v);
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = __fmaf_rn(d, v[w], acc[w]);
}

// Thread (blockIdx, threadIdx) -> tile t, rows g0 .. g0 + R - 1, columns
// c0 .. c0 + W - 1: a block holds blockDim.x / tile_threads tiles, and a
// tile's tile_threads = slab * group / R threads are (row block, column
// unit) with the unit fastest; blockIdx.y picks the slab of column units.
template <int LANE, int W, int R>
__global__ void __launch_bounds__(kThreads) hbp_partials_sum_kernel(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const float* __restrict__ x,
    float* __restrict__ partial, int n_tiles, int group, int lane_rt, int col_block,
    int k, int slab, int tile_threads) {
  const int j = threadIdx.x % tile_threads;
  const int t = blockIdx.x * (blockDim.x / tile_threads) + threadIdx.x / tile_threads;
  const int c0 = (blockIdx.y * slab + j % slab) * W;
  if (t >= n_tiles || c0 >= k) return;
  const int64_t kk = k;
  const int64_t row0 = static_cast<int64_t>(t) * group + j / slab * R;
  const float* __restrict__ xs =
      x + static_cast<int64_t>(__ldg(colblock + t)) * col_block * kk + c0;
  float acc[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[r][w] = 0.0f;
  if constexpr (LANE > 0) {
    static_assert(LANE % kStep == 0, "lane must be a multiple of 8");
    // unroll to about 64 slots (8 steps of one row, 1 step of 8 rows)
#pragma unroll(8 / R)
    for (int s = 0; s < LANE; s += kStep) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t at = (row0 + r) * LANE + s;
        const int4* cp = reinterpret_cast<const int4*>(cols + at);
        const float4* dp = reinterpret_cast<const float4*>(data + at);
        const int4 ca = __ldg(cp), cb = __ldg(cp + 1);
        const float4 da = __ldg(dp), db = __ldg(dp + 1);
        slot<W>(acc[r], da.x, xs, ca.x, kk);
        slot<W>(acc[r], da.y, xs, ca.y, kk);
        slot<W>(acc[r], da.z, xs, ca.z, kk);
        slot<W>(acc[r], da.w, xs, ca.w, kk);
        slot<W>(acc[r], db.x, xs, cb.x, kk);
        slot<W>(acc[r], db.y, xs, cb.y, kk);
        slot<W>(acc[r], db.z, xs, cb.z, kk);
        slot<W>(acc[r], db.w, xs, cb.w, kk);
      }
    }
  } else {
    for (int l = 0; l < lane_rt; ++l) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t at = (row0 + r) * lane_rt + l;
        slot<W>(acc[r], __ldg(data + at), xs, __ldg(cols + at), kk);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) store_cols<W>(partial + (row0 + r) * kk + c0, acc[r]);
}

template <int W, int R>
cudaError_t launch_sum_wr(const float* data, const int* cols, const int* colblock,
                          const float* x, float* partial, int n_tiles, int group,
                          int lane, int col_block, int k, int slab, int tile_threads,
                          dim3 grid, int block, cudaStream_t s) {
#define HBP_LAUNCH(L)                                                         \
  hbp_partials_sum_kernel<L, W, R><<<grid, block, 0, s>>>(                    \
      data, cols, colblock, x, partial, n_tiles, group, lane, col_block, k,   \
      slab, tile_threads)
  HBP_DISPATCH_LANE(lane, HBP_LAUNCH)
#undef HBP_LAUNCH
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The geometry (width, rows, slab, block, grid) comes from the caller;
// this checks that it is one the kernel can run safely.
int launch_sum(const float* data, const int* cols, const int* colblock, const float* x,
               float* partial, int n_tiles, int group, int lane, int col_block, int k,
               int width, int rows, int slab, int block, int grid_x, int grid_y,
               int device, void* stream) {
  if (n_tiles < 0 || group <= 0 || lane <= 0 || col_block <= 0 || k <= 0 ||
      rows <= 0 || group % rows != 0 || slab <= 0 || block <= 0 ||
      block > kThreads || block % (slab * (group / rows)) != 0 || grid_x < 0 ||
      grid_y <= 0 || grid_y > 65535 || !aligned16(data) || !aligned16(cols))
    return static_cast<int>(cudaErrorInvalidValue);
  if (width > 1 && (k % width != 0 || !aligned16(x) || !aligned16(partial)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the grid must cover every tile and every column
  const int tile_threads = slab * (group / rows);
  if (static_cast<int64_t>(grid_x) * (block / tile_threads) < n_tiles ||
      static_cast<int64_t>(grid_y) * slab * width < k)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev = cudaSetDevice(device);
  if (dev != cudaSuccess) return static_cast<int>(dev);
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HBP_WR(W, R)                                                                 \
  launch_sum_wr<W, R>(data, cols, colblock, x, partial, n_tiles, group, lane,       \
                      col_block, k, slab, tile_threads, grid, block, s)
  switch (width * 16 + rows) {
    case 0x11: return static_cast<int>(HBP_WR(1, 1));
    case 0x12: return static_cast<int>(HBP_WR(1, 2));
    case 0x14: return static_cast<int>(HBP_WR(1, 4));
    case 0x18: return static_cast<int>(HBP_WR(1, 8));
    case 0x41: return static_cast<int>(HBP_WR(4, 1));
    case 0x42: return static_cast<int>(HBP_WR(4, 2));
    case 0x44: return static_cast<int>(HBP_WR(4, 4));
    case 0x48: return static_cast<int>(HBP_WR(4, 8));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HBP_WR
}

// Kernel 4: one thread per output element (t, g, c), c fastest.
template <int LANE>
__global__ void __launch_bounds__(kThreads) hbp_partials_max_kernel(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const float* __restrict__ x,
    float* __restrict__ partial, int64_t n_out, int group, int lane, int col_block,
    int k) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int64_t per_tile = static_cast<int64_t>(group) * k;
  const int t = static_cast<int>(e / per_tile);
  const int rem = static_cast<int>(e - t * per_tile);
  const int g = rem / k;
  const int c = rem - g * k;
  partial[e] = hbp::tile_chain<LANE, hbp::MaxOp>(data, cols, colblock, x, t, t + 1, g,
                                                 group, lane, col_block, k, c);
}

int launch_max(const float* data, const int* cols, const int* colblock, const float* x,
               float* partial, int n_tiles, int group, int lane, int col_block, int k,
               int device, void* stream) {
  if (n_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_out = static_cast<int64_t>(n_tiles) * group * k;
  dim3 grid;
  const cudaError_t ready =
      hbp::prepare_launch(n_out, group, lane, col_block, k, device, &grid);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HBP_LAUNCH(L)                                                         \
  hbp_partials_max_kernel<L><<<grid, kThreads, 0, s>>>(                       \
      data, cols, colblock, x, partial, n_out, group, lane, col_block, k)
  HBP_DISPATCH_LANE(lane, HBP_LAUNCH)
#undef HBP_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// partial: f32[n_tiles, group]; x: f32[n_x].  The geometry as for the SpMM
// at k = 1.
int hbp_spmv_partials_launch(const float* data, const int* cols, const int* colblock,
                             const float* x, float* partial, int n_tiles, int group,
                             int lane, int col_block, int width, int rows, int slab,
                             int block, int grid_x, int grid_y, int device,
                             void* stream) {
  return launch_sum(data, cols, colblock, x, partial, n_tiles, group, lane, col_block,
                    1, width, rows, slab, block, grid_x, grid_y, device, stream);
}

// partial: f32[n_tiles, group, k]; x: f32[n_x, k]; the launch geometry of
// partials_geometry (hbp_spmv.py).
int hbp_spmm_partials_launch(const float* data, const int* cols, const int* colblock,
                             const float* x, float* partial, int n_tiles, int group,
                             int lane, int col_block, int k, int width, int rows,
                             int slab, int block, int grid_x, int grid_y, int device,
                             void* stream) {
  return launch_sum(data, cols, colblock, x, partial, n_tiles, group, lane, col_block,
                    k, width, rows, slab, block, grid_x, grid_y, device, stream);
}

// partial: f32[n_tiles, group, k], -inf where a tile row has no live slot.
int hbp_spmm_partials_max_launch(const float* data, const int* cols,
                                 const int* colblock, const float* x, float* partial,
                                 int n_tiles, int group, int lane, int col_block,
                                 int k, int device, void* stream) {
  return launch_max(data, cols, colblock, x, partial, n_tiles, group, lane, col_block,
                    k, device, stream);
}

}  // extern "C"
