// The argmax SpMM for Hopper (sm_90a), plain C interface: the max-monoid
// SpMM with its winners, the forward of max aggregation's gradient.
//
// Replaces no TPU kernel.  In the JAX package the argmax SpMM is jnp code
// (src/repro/kernels/ref.py, hbp_spmm_hashed_argmax_onepass), not a
// pallas_call; the port ran the same torch lane chain on the card
// (kernels/ref.py), at more than 100x kernel 3's time on the same tiles
// (PERF.md).  This kernel is the card's path of ops.hbp_spmm_argmax
// (passes=1):
//   hbp_spmm_fused_argmax_launch
// computes, in hashed row order, for every row group rg, row g, column c,
//   y[rg, g, c]     = the max over the live slots (d != 0) of the row
//                     group's run of d * x[gcol, c] (kernel 3's value)
//   idx[rg, g, c]   = the lowest gcol among the live slots whose product
//                     compares equal to y (+0.0 == -0.0)
//   coeff[rg, g, c] = that slot's stored value d
// with gcol = colblock[t] * col_block + cols[t, g, l], x row-major [n_x, k]
// and the outputs row-major [n_rowgroups, group, k].  A row with no live
// slot gives (-inf, -1, 0) and a NaN max gives (NaN, -1, 0): the reference
// has no slot "attain" a NaN.  A live product of -inf keeps its column.
// Row groups without tiles are never written: the caller fills the outputs
// with (-inf, -1, 0).
//
// Why a chain over tiles gives the reference's bits.  The reference folds
// each tile's lanes, then combines the tiles of a run.  Here one
// accumulator (v, col, coeff) starts at (-inf, INT32_MAX, 0) and takes
// each slot's term (p, gcol, d), p = __fmul_rn(d, x), by
//   take = p > v || (p == v && gcol < col);  v = max_nan(v, p);
//   if take: col = gcol, coeff = d
// (a masked slot's term is (-inf, INT32_MAX, 0), which never takes).
// Without NaN, v is the max of the terms so far and col the lowest column
// among those equal to it: a fold that depends on neither grouping nor
// order, so the chunks and their fold give the per-tile reference's
// triple.  Once v is NaN nothing takes, and the epilogue maps a NaN row to
// (-1, 0).  Admission merges duplicate entries, so one slot holds each
// (row, column) and coeff follows col.  v is max_nan's chain, kernel 3's
// MaxOp, so y is bitwise hbp_spmm_fused_max's.
//
// Design: kernel 3 (hbp_spmv.cu, hbp_rows.cuh) with a triple payload.
// * Phase A walks the chunk index of ops.device_tiles (at most RUN_CHUNK
//   tiles a chunk) in kernel 3's geometry (hbp_spmv.py partials_geometry
//   over the chunks, one row a thread; W = 4 columns as a float4 where
//   k % 4 == 0 and the operands are 16-byte aligned, else W = 1), and
//   skips a masked slot's gather where a warp's 32 threads share their
//   row (slab a multiple of 32).  A one-chunk run writes its row group's
//   three outputs; a chunk of a split run writes its row of three chunk
//   buffers [n_split_chunks, group, k].
// * Phase B (hbp_argmax_fold_kernel) left-folds each split run's chunk
//   triples in chunk order under the same rule: hbp_fold_kernel with the
//   payload.
// * Outputs are written with streaming stores (__stcs).
// * A kernel of its own rather than hbp_rows.cuh's tile_rows over a
//   payload type: a triple takes three registers an output where MaxOp
//   takes one, and kernels 3-6 keep their instantiations and registers.
//
// Bound on this card: bytes.  A launch reads the matrix as CSR and x once
// and writes the three outputs once (h100bench/work: spmm(outputs=3)): on
// h100bench's kron16 graph (4,116,994 entries, 65,536 rows) 0.050 ms at
// k = 128 and 0.090 ms at k = 256 at 3.35 TB/s, 0.23 ms for a SAGE-max
// step's three forward launches (0.39 ms with the backward scatter).  As
// for kernel 3, the time goes to the x gathers, which mostly hit L2; the
// payload adds compares and selects to each gathered column, no bytes,
// and two more output streams, which the streaming stores keep out of L2.

#include <climits>

#include "hbp_rows.cuh"

namespace {

using hbp::kStep;
using hbp::kThreads;

// The column of a slot that never wins a tie: masked slots and the start.
constexpr int kNoCol = INT_MAX;

// A thread's W outputs: the max, the winning column and its coefficient.
template <int W>
struct Triple {
  float v[W];
  int col[W];
  float coeff[W];
};

// Folds the term (p, gcol, d) into one output's (v, col, coeff).
__device__ __forceinline__ void take_max(float& v, int& col, float& coeff, float p, int gcol,
                                         float d) {
  const bool take = p > v || (p == v && gcol < col);
  v = hbp::max_nan(v, p);
  col = take ? gcol : col;
  coeff = take ? d : coeff;
}

// One slot of the thread's row: column `col` of the tile whose x segment
// starts at global row `base`, xs pointing at its column c0.  SKIP: a
// masked slot skips its gather (hbp_rows.cuh slot()).
template <int W, bool SKIP>
__device__ __forceinline__ void arg_slot(Triple<W>& a, float d, const float* __restrict__ xs,
                                         int col, int base, int64_t k) {
  if (SKIP && d == 0.0f) return;
  float xv[W];
  hbp::load_cols<W>(xs + col * k, xv);
  const bool live = d != 0.0f;
  const int gcol = live ? base + col : kNoCol;
#pragma unroll
  for (int w = 0; w < W; ++w)
    take_max(a.v[w], a.col[w], a.coeff[w], live ? __fmul_rn(d, xv[w]) : -CUDART_INF_F, gcol,
             d);
}

// Folds row g, columns c0 .. c0 + W - 1 of tiles [t0, t1) into a.
template <int LANE, int W, bool SKIP>
__device__ __forceinline__ void arg_tiles(const float* __restrict__ data,
                                          const int* __restrict__ cols,
                                          const int* __restrict__ colblock,
                                          const float* __restrict__ x, int t0, int t1, int g,
                                          int group, int lane_rt, int col_block, int64_t kk,
                                          int c0, Triple<W>& a) {
  for (int t = t0; t < t1; ++t) {
    const int64_t row = static_cast<int64_t>(t) * group + g;
    const int base = __ldg(colblock + t) * col_block;
    const float* __restrict__ xs = x + base * kk + c0;
    if constexpr (LANE > 0) {
      static_assert(LANE % kStep == 0, "lane must be a multiple of 8");
#pragma unroll 8
      for (int s = 0; s < LANE; s += kStep) {
        const int64_t at = row * LANE + s;
        const int4* cp = reinterpret_cast<const int4*>(cols + at);
        const float4* dp = reinterpret_cast<const float4*>(data + at);
        const int4 ca = __ldg(cp), cb = __ldg(cp + 1);
        const float4 da = __ldg(dp), db = __ldg(dp + 1);
        arg_slot<W, SKIP>(a, da.x, xs, ca.x, base, kk);
        arg_slot<W, SKIP>(a, da.y, xs, ca.y, base, kk);
        arg_slot<W, SKIP>(a, da.z, xs, ca.z, base, kk);
        arg_slot<W, SKIP>(a, da.w, xs, ca.w, base, kk);
        arg_slot<W, SKIP>(a, db.x, xs, cb.x, base, kk);
        arg_slot<W, SKIP>(a, db.y, xs, cb.y, base, kk);
        arg_slot<W, SKIP>(a, db.z, xs, cb.z, base, kk);
        arg_slot<W, SKIP>(a, db.w, xs, cb.w, base, kk);
      }
    } else {
      for (int l = 0; l < lane_rt; ++l) {
        const int64_t at = row * lane_rt + l;
        arg_slot<W, SKIP>(a, __ldg(data + at), xs, __ldg(cols + at), base, kk);
      }
    }
  }
}

template <int W>
__device__ __forceinline__ void store_ints(int* p, const int (&v)[W]) {
  if constexpr (W == 1) {
    __stcs(p, v[0]);
  } else {
    __stcs(reinterpret_cast<int4*>(p), make_int4(v[0], v[1], v[2], v[3]));
  }
}

// A chunk of a split run: the raw triple, for the fold.
template <int W>
__device__ __forceinline__ void store_raw(float* v, int* col, float* coeff,
                                          const Triple<W>& a) {
  hbp::store_cols<W>(v, a.v);
  store_ints<W>(col, a.col);
  hbp::store_cols<W>(coeff, a.coeff);
}

// A finished output: no live slot, or a NaN max, has no winner.
template <int W>
__device__ __forceinline__ void store_final(float* y, int* idx, float* coeff, Triple<W>& a) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (a.v[w] != a.v[w] || a.col[w] == kNoCol) {
      a.col[w] = -1;
      a.coeff[w] = 0.0f;
    }
  }
  store_raw<W>(y, idx, coeff, a);
}

// Phase A: thread (blockIdx, threadIdx) -> chunk i, row g, columns
// c0 .. c0 + W - 1 (hbp_rows_kernel's map at one row a thread).
template <int LANE, int W, bool SKIP>
__global__ void __launch_bounds__(kThreads) hbp_argmax_kernel(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const int* __restrict__ chunk_start,
    const int* __restrict__ chunk_dest, const float* __restrict__ x,
    float* __restrict__ part_v, int* __restrict__ part_col, float* __restrict__ part_coeff,
    float* __restrict__ y, int* __restrict__ idx, float* __restrict__ coeff, int n_chunks,
    int group, int lane_rt, int col_block, int k, int slab, int tile_threads) {
  const int j = threadIdx.x % tile_threads;
  const int i = blockIdx.x * (blockDim.x / tile_threads) + threadIdx.x / tile_threads;
  const int c0 = (blockIdx.y * slab + j % slab) * W;
  if (i >= n_chunks || c0 >= k) return;
  const int64_t kk = k;
  const int g = j / slab;
  Triple<W> a;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    a.v[w] = -CUDART_INF_F;
    a.col[w] = kNoCol;
    a.coeff[w] = 0.0f;
  }
  arg_tiles<LANE, W, SKIP>(data, cols, colblock, x, __ldg(chunk_start + i),
                           __ldg(chunk_start + i + 1), g, group, lane_rt, col_block, kk, c0,
                           a);
  const int dest = __ldg(chunk_dest + i);
  const int64_t at = (static_cast<int64_t>(dest >= 0 ? dest : ~dest) * group + g) * kk + c0;
  if (dest >= 0) {
    store_final<W>(y + at, idx + at, coeff + at, a);
  } else {
    store_raw<W>(part_v + at, part_col + at, part_coeff + at, a);
  }
}

// Phase B: one thread per (split run, g, c) left-folds the run's chunk
// triples, whose chunk-buffer rows are consecutive from
// ~chunk_dest[first chunk], in chunk order.
__global__ void __launch_bounds__(kThreads) hbp_argmax_fold_kernel(
    const int* __restrict__ run_chunk, const int* __restrict__ split_run,
    const int* __restrict__ chunk_dest, const int* __restrict__ run_rowgroup,
    const float* __restrict__ part_v, const int* __restrict__ part_col,
    const float* __restrict__ part_coeff, float* __restrict__ y, int* __restrict__ idx,
    float* __restrict__ coeff, int64_t n_out, int group, int k) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int64_t per_run = static_cast<int64_t>(group) * k;
  const int64_t s = e / per_run;
  const int64_t rem = e - s * per_run;
  const int r = __ldg(split_run + s);
  const int c0 = __ldg(run_chunk + r);
  const int n = __ldg(run_chunk + r + 1) - c0;
  const int64_t at = static_cast<int64_t>(~__ldg(chunk_dest + c0)) * per_run + rem;
  Triple<1> a{{__ldg(part_v + at)}, {__ldg(part_col + at)}, {__ldg(part_coeff + at)}};
  for (int c = 1; c < n; ++c) {
    const int64_t p = at + c * per_run;
    take_max(a.v[0], a.col[0], a.coeff[0], __ldg(part_v + p), __ldg(part_col + p),
             __ldg(part_coeff + p));
  }
  const int64_t out = static_cast<int64_t>(__ldg(run_rowgroup + r)) * per_run + rem;
  store_final<1>(y + out, idx + out, coeff + out, a);
}

template <int W>
cudaError_t launch_chains(const float* data, const int* cols, const int* colblock,
                          const int* chunk_start, const int* chunk_dest, const float* x,
                          float* part_v, int* part_col, float* part_coeff, float* y, int* idx,
                          float* coeff, int n_chunks, int group, int lane, int col_block,
                          int k, int slab, bool skip, dim3 grid, int block, cudaStream_t s) {
  const int tile_threads = slab * group;
#define HBP_LAUNCH(L)                                                                        \
  hbp_argmax_kernel<L, W, SKIP><<<grid, block, 0, s>>>(                                      \
      data, cols, colblock, chunk_start, chunk_dest, x, part_v, part_col, part_coeff, y, idx, \
      coeff, n_chunks, group, lane, col_block, k, slab, tile_threads)
  if (skip) {
    constexpr bool SKIP = true;
    HBP_DISPATCH_LANE(lane, HBP_LAUNCH)
  } else {
    constexpr bool SKIP = false;
    HBP_DISPATCH_LANE(lane, HBP_LAUNCH)
  }
#undef HBP_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y: f32, filled with -inf; idx: i32, filled with -1; coeff: f32, zero-filled
// (each [n_rowgroups, group, k], by the caller); x: f32[n_x, k];
// part_v, part_col, part_coeff: f32, i32, f32 [n_split_chunks, group, k],
// uninitialised; the launch geometry of partials_geometry (hbp_spmv.py)
// over the n_chunks chunks at one row a thread.
int hbp_spmm_fused_argmax_launch(const float* data, const int* cols, const int* colblock,
                                 const int* chunk_start, const int* chunk_dest,
                                 const int* run_chunk, const int* split_run,
                                 const int* run_rowgroup, const float* x, float* part_v,
                                 int* part_col, float* part_coeff, float* y, int* idx,
                                 float* coeff, int n_chunks, int n_split, int group, int lane,
                                 int col_block, int k, int width, int rows, int slab,
                                 int block, int grid_x, int grid_y, int device, void* stream) {
  if (n_chunks < 0 || n_split < 0 || n_split > n_chunks || k <= 0 || rows != 1 ||
      (width != 1 && width != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (width > 1 && !(hbp::aligned16(part_col) && hbp::aligned16(part_coeff) &&
                     hbp::aligned16(idx) && hbp::aligned16(coeff)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_fold = static_cast<int64_t>(n_split) * group * k;
  dim3 fold_grid;
  cudaError_t err = hbp::grid_for(n_fold, &fold_grid);
  if (err == cudaSuccess)
    err = hbp::prepare_rows(data, cols, x, part_v, y, n_chunks, group, lane, col_block, k,
                            width, rows, slab, block, grid_x, grid_y, device);
  if (err != cudaSuccess || n_chunks == 0) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool skip = slab % 32 == 0;  // a warp's 32 threads share their row
  err = width == 4
            ? launch_chains<4>(data, cols, colblock, chunk_start, chunk_dest, x, part_v,
                               part_col, part_coeff, y, idx, coeff, n_chunks, group, lane,
                               col_block, k, slab, skip, grid, block, s)
            : launch_chains<1>(data, cols, colblock, chunk_start, chunk_dest, x, part_v,
                               part_col, part_coeff, y, idx, coeff, n_chunks, group, lane,
                               col_block, k, slab, skip, grid, block, s);
  if (err != cudaSuccess || n_fold == 0) return static_cast<int>(err);
  hbp_argmax_fold_kernel<<<fold_grid, kThreads, 0, s>>>(run_chunk, split_run, chunk_dest,
                                                        run_rowgroup, part_v, part_col,
                                                        part_coeff, y, idx, coeff, n_fold,
                                                        group, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
