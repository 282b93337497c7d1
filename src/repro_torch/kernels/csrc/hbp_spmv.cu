// Fused-combine HBP SpMV and SpMM for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/hbp_spmv.py:
//   hbp_spmv_fused_launch      <- _fused_kernel / hbp_spmv_fused
//   hbp_spmm_fused_launch      <- _fused_spmm_kernel / hbp_spmm_fused
//   hbp_spmm_fused_max_launch  <- _fused_spmm_max_kernel / hbp_spmm_fused_max
// All compute, in hashed row order,
//   y[rg, g, c] = (+ or max) over the tiles t of row group rg (stream order)
//                 over lanes l = 0 .. lane-1 (in order)
//                 of data[t, g, l] * x[colblock[t] * col_block + cols[t, g, l], c]
// with x row-major [n_x, k] (k = 1 for SpMV) and y row-major
// [n_rowgroups, group, k]; the max monoid masks slots whose stored value
// is 0 and carries NaN (hbp_chain.cuh).
//
// Design.
// * Runs replace the sequential grid.  The TPU kernel accumulates into an
//   output block across consecutive grid steps; GPU blocks run in no order.
//   Tiles are sorted by (rowgroup, colblock), so each row group owns one
//   contiguous run [run_start[r], run_start[r + 1]).  Row groups without
//   tiles are never written: the caller fills the output with the
//   monoid's identity (0 for the sum, -inf for the max, which the entry
//   point maps to 0 after assembly).  No atomic touches a value.
// * Chunks bound the serial walk.  A power-law hub row group owns a run
//   of thousands of tiles, and one thread walking it set the whole
//   launch's time.  The staging step (ops.device_tiles) cuts every run
//   into consecutive chunks of at most RUN_CHUNK tiles, so no thread walks
//   more, and each launcher runs two kernels on the caller's stream:
//     A. the chunk chains: each chunk's tiles folded into its outputs; a
//        run of one chunk writes y directly, a chunk of a split run writes
//        its row of the chunk buffer partial[n_split_chunks, group, k]
//        (allocated by the caller, uninitialised);
//     B. hbp_fold_kernel (hbp_rows.cuh): one thread per (split run, g, c)
//        left-folds the run's chunk partials in chunk order into y
//        (__fadd_rn, or the NaN-carrying max).
//   A is hbp_chunk_kernel for the sum (one thread per (chunk, g, c)) and
//   the tile-row kernel of hbp_rows.cuh for the max (kernel 3): a
//   chunk's threads are (row block, column unit), R rows and 4 columns
//   (a float4 of each x row) or 1 a thread, in the launch geometry the
//   wrapper picks (hbp_spmv.py partials_geometry), so a chunk's x rows are
//   gathered on one SM (and masked slots skip their gather where a warp's
//   threads share their rows: k >= 128, or k >= 32 on scalar columns).
//   Two launches rather than one with per-run arrival counters, which
//   would need a fence and a reset per run and a counter array shared by
//   every launch on the tiles.  The fold is cheap: on m4_kron16 (RUN_CHUNK
//   32, 1,216 split runs) it adds 0.008, 0.012 and 0.022 ms to chains of
//   0.048, 0.083 and 0.965 ms at k = 1, 8 and 128 (H100 SXM, 700 W;
//   scripts/time_fused.py, PERF.md).
// * One accumulation order for every width (sum).  The chunk boundaries
//   depend on the tiles alone, each chunk is one __fmaf_rn chain over its tiles
//   in stream order and lanes in order, and the fold order is the chunk
//   order; SpMV is the same template at k = 1.  So SpMV(x) is bitwise
//   column c of SpMM(X) whenever X[:, c] = x, at any k and any zero
//   padding of k: a batched serving answer equals the one-vector answer.
//   A run of one chunk gets exactly the bits of one chain over its run.
// * Loads.  For lanes 8..128 each tile row is read as 16-byte vectors
//   (int4 cols, float4 data) and the next step's row is loaded while this
//   step's x gathers are in flight (vec_sum_chain); other lane counts run
//   the scalar chain (scalar_sum_chain).  Both are compile-time
//   specialisations.
// * Sum output elements are flattened as (chunk, g, c), c fastest: for small k
//   several chunks share one block of threads, for wide k one chunk spans
//   several blocks, and neighbouring threads read neighbouring columns of
//   an x row.
// * Max: exact in any order, so the chunks and the fold give the bits of
//   one max over the run; a NaN product of a live slot reaches y.
//
// Bound on this card: bytes.  Each stored slot costs 8 bytes of tile
// stream (value + column id) for 2 operations per column of x; even at
// k = 128 the tile stream plus x and y take about as long to move as the
// operations take to issue, and below that the memory side dominates.  x
// is read straight from global memory: its rows are re-read by every tile
// that touches them and mostly hit the 50 MB L2.  The chunk buffer adds
// 2 * n_split_chunks * group * k * 4 bytes, a small share of the partials
// kernels' per-tile buffer.  Staging x segments in shared memory and
// reusing tile rows across columns are left to measured follow-up work.

#include "hbp_rows.cuh"

namespace {

using hbp::kThreads;

// Phase A of the sum: one chain per (chunk, g, c).  K1 = true is the SpMV
// entry: k fixed at 1, otherwise the same code.
template <int LANE, bool K1>
__global__ void __launch_bounds__(kThreads) hbp_chunk_kernel(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const int* __restrict__ chunk_start,
    const int* __restrict__ chunk_dest, const float* __restrict__ x,
    float* __restrict__ partial, float* __restrict__ y, int64_t n_out, int group,
    int lane, int col_block, int k_rt) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int k = K1 ? 1 : k_rt;
  const int64_t per_chunk = static_cast<int64_t>(group) * k;
  const int64_t i = e / per_chunk;
  const int rem = static_cast<int>(e - i * per_chunk);
  const int g = rem / k;
  const int c = rem - g * k;
  const int t0 = __ldg(chunk_start + i), t1 = __ldg(chunk_start + i + 1);
  float acc;
  if constexpr (LANE > 0) {
    acc = hbp::vec_sum_chain<LANE>(data, cols, colblock, x, t0, t1, g, group,
                                   col_block, k, c);
  } else {
    acc = hbp::scalar_sum_chain(data, cols, colblock, x, t0, t1, g, group, lane,
                                col_block, k, c);
  }
  const int dest = __ldg(chunk_dest + i);
  float* out = dest >= 0 ? y + static_cast<int64_t>(dest) * per_chunk
                         : partial + static_cast<int64_t>(~dest) * per_chunk;
  out[rem] = acc;
}

template <bool K1>
int launch_sum(const float* data, const int* cols, const int* colblock,
               const int* chunk_start, const int* chunk_dest, const int* run_chunk,
               const int* split_run, const int* run_rowgroup, const float* x,
               float* partial, float* y, int n_chunks, int n_split, int group,
               int lane, int col_block, int k, int device, void* stream) {
  if (n_chunks < 0 || n_split < 0 || n_split > n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_out = static_cast<int64_t>(n_chunks) * group * k;
  const int64_t n_fold = static_cast<int64_t>(n_split) * group * k;
  dim3 grid, fold_grid;
  cudaError_t ready =
      hbp::prepare_launch(n_out, group, lane, col_block, k, device, &grid);
  if (ready == cudaSuccess) ready = hbp::grid_for(n_fold, &fold_grid);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HBP_LAUNCH(L)                                                            \
  hbp_chunk_kernel<L, K1><<<grid, kThreads, 0, s>>>(                             \
      data, cols, colblock, chunk_start, chunk_dest, x, partial, y, n_out, group, \
      lane, col_block, k)
  HBP_DISPATCH_LANE(lane, HBP_LAUNCH)
#undef HBP_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_fold == 0) return static_cast<int>(err);
  hbp::hbp_fold_kernel<K1, hbp::SumOp><<<fold_grid, kThreads, 0, s>>>(
      run_chunk, split_run, chunk_dest, run_rowgroup, partial, y, n_fold, group, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y: f32[n_rowgroups, group], zero-filled by the caller; x: f32[n_x];
// partial: f32[n_split_chunks, group], uninitialised.
int hbp_spmv_fused_launch(const float* data, const int* cols, const int* colblock,
                          const int* chunk_start, const int* chunk_dest,
                          const int* run_chunk, const int* split_run,
                          const int* run_rowgroup, const float* x, float* partial,
                          float* y, int n_chunks, int n_split, int group, int lane,
                          int col_block, int device, void* stream) {
  return launch_sum<true>(data, cols, colblock, chunk_start, chunk_dest, run_chunk,
                          split_run, run_rowgroup, x, partial, y, n_chunks, n_split,
                          group, lane, col_block, 1, device, stream);
}

// y: f32[n_rowgroups, group, k], zero-filled by the caller; x: f32[n_x, k];
// partial: f32[n_split_chunks, group, k], uninitialised.
int hbp_spmm_fused_launch(const float* data, const int* cols, const int* colblock,
                          const int* chunk_start, const int* chunk_dest,
                          const int* run_chunk, const int* split_run,
                          const int* run_rowgroup, const float* x, float* partial,
                          float* y, int n_chunks, int n_split, int group, int lane,
                          int col_block, int k, int device, void* stream) {
  return launch_sum<false>(data, cols, colblock, chunk_start, chunk_dest, run_chunk,
                           split_run, run_rowgroup, x, partial, y, n_chunks, n_split,
                           group, lane, col_block, k, device, stream);
}

// y: f32[n_rowgroups, group, k], filled with -inf by the caller; x: f32[n_x, k];
// partial: f32[n_split_chunks, group, k], uninitialised; the launch geometry
// of partials_geometry (hbp_spmv.py) over the n_chunks chunks.
int hbp_spmm_fused_max_launch(const float* data, const int* cols, const int* colblock,
                              const int* chunk_start, const int* chunk_dest,
                              const int* run_chunk, const int* split_run,
                              const int* run_rowgroup, const float* x, float* partial,
                              float* y, int n_chunks, int n_split, int group, int lane,
                              int col_block, int k, int width, int rows, int slab,
                              int block, int grid_x, int grid_y, int device,
                              void* stream) {
  if (n_chunks < 0 || n_split < 0 || n_split > n_chunks || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_fold = static_cast<int64_t>(n_split) * group * k;
  dim3 fold_grid;
  cudaError_t err = hbp::grid_for(n_fold, &fold_grid);
  if (err == cudaSuccess)
    err = hbp::launch_rows<hbp::MaxOp, true>(
        data, cols, colblock, chunk_start, chunk_dest, x, partial, y, n_chunks, group, lane,
        col_block, k, width, rows, slab, block, grid_x, grid_y, device, stream);
  if (err != cudaSuccess || n_fold == 0) return static_cast<int>(err);
  hbp::hbp_fold_kernel<false, hbp::MaxOp><<<fold_grid, kThreads, 0,
                                            static_cast<cudaStream_t>(stream)>>>(
      run_chunk, split_run, chunk_dest, run_rowgroup, partial, y, n_fold, group, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
