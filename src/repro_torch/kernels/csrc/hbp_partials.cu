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
// Design of the sum kernels (kernels 5-6, SpMV and SpMM): a
// tile's x rows gathered by the warps of one block, in the geometry of the
// tile-row kernel (hbp_rows.cuh), whose checks and dispatch they share.
// * A thread owns W columns (W = 4: one float4 of each x row it gathers,
//   float4 stores; W = 1: the scalar-column path) of R consecutive rows of
//   one tile.  The wrapper picks the geometry (hbp_spmv.py
//   partials_geometry): a tile gets up to 64 threads, all in one block.
//   At k = 128 that is two warps of 32 column quads, each warp 4 of the
//   tile's 8 rows; at k <= 32 one row per thread (k = 1: four tiles per
//   warp).  On m4_kron16 (H100 SXM, 700 W; scripts/time_fused.py
//   --geometry-sweep, PERF.md) two warps per tile beat one (8 rows a
//   thread) and four by 7-17 %, and 4 columns a thread beat 8.  So a
//   tile's x rows are gathered on one SM: the slots that repeat a row
//   (most are padded slots, column 0) hit L1 rather than L2.
// * Tile rows are read as 16-byte vectors (int4 cols, float4 data) for
//   lanes 8..128, broadcast to a row block's threads; other lane counts
//   read scalars.
// * Each accumulator is one __fmaf_rn chain over its row's lanes in
//   order, from 0.0f: neither the geometry nor the path changes a bit,
//   SpMV is bitwise column c of the SpMM whenever X[:, c] = x, and padded
//   slots stay in the chain (0 * x[col 0], as on the TPU).
// * The partials are written with streaming stores (__stcs), so the
//   buffer does not evict x from the 50 MB L2 (plain stores: 0.62 ms
//   against 0.47 at k = 128 on m4_kron16, PERF.md).
// * Offsets into x and the buffer are 64-bit (T * group * k * 4 passes
//   2^31 bytes at k = 256 on m4_kron16); per-thread index math is 32-bit.
//
// The max kernel (kernel 4) is the tile-row kernel of hbp_rows.cuh, one
// item per tile, under MaxOp: the same geometry, -inf for the chains'
// start, max_nan for their step, and each masked slot's gather skipped
// where a warp's rows are uniform.  Each max output is exact.  Kernels
// 5-6 on that body gave the same bits and up to 2 % more device time on
// m4_kron16 (H100 SXM, 700 W; scripts/time_fused.py, PERF.md), so the sum
// keeps its own.

#include "hbp_rows.cuh"

namespace {

using hbp::kStep;  // lanes per step of a tile row: two int4 and two float4
using hbp::kThreads;

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
        hbp::slot<W, hbp::SumOp, false>(acc[r], da.x, xs, ca.x, kk);
        hbp::slot<W, hbp::SumOp, false>(acc[r], da.y, xs, ca.y, kk);
        hbp::slot<W, hbp::SumOp, false>(acc[r], da.z, xs, ca.z, kk);
        hbp::slot<W, hbp::SumOp, false>(acc[r], da.w, xs, ca.w, kk);
        hbp::slot<W, hbp::SumOp, false>(acc[r], db.x, xs, cb.x, kk);
        hbp::slot<W, hbp::SumOp, false>(acc[r], db.y, xs, cb.y, kk);
        hbp::slot<W, hbp::SumOp, false>(acc[r], db.z, xs, cb.z, kk);
        hbp::slot<W, hbp::SumOp, false>(acc[r], db.w, xs, cb.w, kk);
      }
    }
  } else {
    for (int l = 0; l < lane_rt; ++l) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t at = (row0 + r) * lane_rt + l;
        hbp::slot<W, hbp::SumOp, false>(acc[r], __ldg(data + at), xs, __ldg(cols + at), kk);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) hbp::store_cols<W>(partial + (row0 + r) * kk + c0, acc[r]);
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

// The geometry (width, rows, slab, block, grid) comes from the caller;
// hbp::prepare_rows checks it.
cudaError_t launch_sum(const float* data, const int* cols, const int* colblock,
                       const float* x, float* partial, int n_tiles, int group, int lane,
                       int col_block, int k, int width, int rows, int slab, int block,
                       int grid_x, int grid_y, int device, void* stream) {
  const cudaError_t ready =
      hbp::prepare_rows(data, cols, x, partial, nullptr, n_tiles, group, lane, col_block, k,
                        width, rows, slab, block, grid_x, grid_y, device);
  if (ready != cudaSuccess || n_tiles == 0) return ready;
  const int tile_threads = slab * (group / rows);
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HBP_WR(W, R)                                                                 \
  launch_sum_wr<W, R>(data, cols, colblock, x, partial, n_tiles, group, lane,       \
                      col_block, k, slab, tile_threads, grid, block, s)
  HBP_DISPATCH_WR(width, rows, HBP_WR)
#undef HBP_WR
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
  return static_cast<int>(launch_sum(data, cols, colblock, x, partial, n_tiles, group,
                                     lane, col_block, 1, width, rows, slab, block, grid_x,
                                     grid_y, device, stream));
}

// partial: f32[n_tiles, group, k]; x: f32[n_x, k]; the launch geometry of
// partials_geometry (hbp_spmv.py).
int hbp_spmm_partials_launch(const float* data, const int* cols, const int* colblock,
                             const float* x, float* partial, int n_tiles, int group,
                             int lane, int col_block, int k, int width, int rows,
                             int slab, int block, int grid_x, int grid_y, int device,
                             void* stream) {
  return static_cast<int>(launch_sum(data, cols, colblock, x, partial, n_tiles, group,
                                     lane, col_block, k, width, rows, slab, block, grid_x,
                                     grid_y, device, stream));
}

// partial: f32[n_tiles, group, k], -inf where a tile row has no live slot;
// the geometry as for the sum.
int hbp_spmm_partials_max_launch(const float* data, const int* cols,
                                 const int* colblock, const float* x, float* partial,
                                 int n_tiles, int group, int lane, int col_block, int k,
                                 int width, int rows, int slab, int block, int grid_x,
                                 int grid_y, int device, void* stream) {
  return static_cast<int>(hbp::launch_rows<hbp::MaxOp, false>(
      data, cols, colblock, nullptr, nullptr, x, partial, nullptr, n_tiles, group, lane,
      col_block, k, width, rows, slab, block, grid_x, grid_y, device, stream));
}

}  // extern "C"
