// The tile-row kernel of the SpMM kernels for Hopper (sm_90a): the fused
// sum (hbp_spmv.cu, kernel 2), the fused max (kernel 3) and the partials
// max (hbp_partials.cu, kernel 4).  The partials sum kernels (kernels 5-6)
// run the same geometry with a body of their own and share its checks and
// dispatch (prepare_rows, HBP_DISPATCH_WR).
//
// A thread folds `R` consecutive rows and `W` columns (W = 4: one float4
// of each x row it gathers, float4 stores; W = 2: float2, for the fused
// sum at an even k that is not a multiple of 4; W = 1: the scalar-column
// path) of the tiles of one item under a monoid of hbp_chain.cuh.  An
// item is one tile (the partials max: out[t, g, c] is tile t's row g) or
// one chunk of a row-group run (the fused kernels: tiles [chunk_start[i],
// chunk_start[i + 1]), at most ops.RUN_CHUNK of them, written to the row
// group's output row, or to the chunk buffer row ~chunk_dest[i] for a
// chunk of a split run).  An item's tile_threads = slab * group / R
// threads are (row block, column unit), the unit fastest; a block of
// `block` threads holds block / tile_threads items, and blockIdx.y picks
// the slab of column units of wider k.  The wrapper picks the geometry
// (hbp_spmv.py fused_sum_geometry, partials_geometry); prepare_rows
// checks it.
//
// * A thread keeps its R x W accumulators across the item's tiles, so an
//   item's x rows are gathered on one SM: the slots that repeat an x row
//   hit L1 rather than L2, and a gather moves W columns at once (a warp
//   of one row reads 32 * 4 * W contiguous bytes of an x row): W
//   multiply-adds a load.
// * Tile rows are read as 16-byte vectors (int4 cols, float4 data) for
//   lanes 8..128; the threads of a row block read the same addresses, so
//   a load is a broadcast, not one fetch per thread.  Other lane counts
//   read scalars.
// * Each accumulator is one chain over its row's slots, tiles in stream
//   order and lanes in order, from the identity: a thread's rows and
//   columns are independent chains, so neither the geometry nor the
//   column path changes a bit.  Under the sum, padded slots stay in the
//   chain (0 * x[col 0], as on the TPU); under the max a masked slot is
//   the identity, so its gather may be skipped (SKIP).  launch_rows skips
//   where a warp's 32 threads share their rows (slab a multiple of 32,
//   k >= 128 on the vector path), so the branch is uniform: on m4_kron16
//   (H100 SXM, 700 W; scripts/time_fused.py, PERF.md) skipping saved
//   10 % of the partials max at k = 128 and 256, where it gathers 16-byte
//   quads for 36 % live slots, and cost up to 25 % at k = 8, where the
//   rows of a warp diverge; gathering and masking with a select is
//   branch-free.
// * Outputs are written with streaming stores (__stcs), so they do not
//   evict x from the 50 MB L2.
// * Offsets into x and the outputs are 64-bit; per-thread index math is
//   32-bit.

#pragma once

#include "hbp_chain.cuh"

namespace hbp {

// The thread's W columns of one x row: W = 1, W = 2 read as a float2, or
// W = 4 read as a float4.
template <int W>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, float (&v)[W]) {
  static_assert(W == 1 || W == 2 || W == 4, "a thread owns 1, 2 or 4 columns");
  if constexpr (W == 1) {
    v[0] = __ldg(p);
  } else if constexpr (W == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x;
    v[1] = f.y;
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
  } else if constexpr (W == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
}

// One slot of one row: acc[w] = Op::step(acc[w], d, x[col, c0 + w]), xs
// pointing at column c0 of the tile's x segment.  SKIP: a masked slot
// (the identity, whatever x holds) skips its gather.
template <int W, class Op, bool SKIP>
__device__ __forceinline__ void slot(float (&acc)[W], float d, const float* __restrict__ xs,
                                     int col, int64_t k) {
  static_assert(!SKIP || Op::kMasked, "only a masked monoid may skip a slot");
  if (SKIP && d == 0.0f) return;
  float v[W];
  load_cols<W>(xs + col * k, v);
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = Op::step(acc[w], d, v[w]);
}

// Folds rows g0 .. g0 + R - 1, columns c0 .. c0 + W - 1 of tiles [t0, t1)
// into acc.
template <int LANE, int W, int R, class Op, bool SKIP>
__device__ __forceinline__ void tile_rows(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const float* __restrict__ x, int t0, int t1,
    int g0, int group, int lane_rt, int col_block, int64_t kk, int c0,
    float (&acc)[R][W]) {
  for (int t = t0; t < t1; ++t) {
    const int64_t row0 = static_cast<int64_t>(t) * group + g0;
    const float* __restrict__ xs =
        x + static_cast<int64_t>(__ldg(colblock + t)) * col_block * kk + c0;
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
          slot<W, Op, SKIP>(acc[r], da.x, xs, ca.x, kk);
          slot<W, Op, SKIP>(acc[r], da.y, xs, ca.y, kk);
          slot<W, Op, SKIP>(acc[r], da.z, xs, ca.z, kk);
          slot<W, Op, SKIP>(acc[r], da.w, xs, ca.w, kk);
          slot<W, Op, SKIP>(acc[r], db.x, xs, cb.x, kk);
          slot<W, Op, SKIP>(acc[r], db.y, xs, cb.y, kk);
          slot<W, Op, SKIP>(acc[r], db.z, xs, cb.z, kk);
          slot<W, Op, SKIP>(acc[r], db.w, xs, cb.w, kk);
        }
      }
    } else {
      for (int l = 0; l < lane_rt; ++l) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int64_t at = (row0 + r) * lane_rt + l;
          slot<W, Op, SKIP>(acc[r], __ldg(data + at), xs, __ldg(cols + at), kk);
        }
      }
    }
  }
}

// Thread (blockIdx, threadIdx) -> item i, rows g0 .. g0 + R - 1, columns
// c0 .. c0 + W - 1.  CHUNKS = false: item i is tile i, written to
// partial[i]; CHUNKS = true: item i is chunk i, written to y[chunk_dest[i]]
// or partial[~chunk_dest[i]].
template <int LANE, int W, int R, class Op, bool CHUNKS, bool SKIP>
__global__ void __launch_bounds__(kThreads) hbp_rows_kernel(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const int* __restrict__ chunk_start,
    const int* __restrict__ chunk_dest, const float* __restrict__ x,
    float* __restrict__ partial, float* __restrict__ y, int n_items, int group,
    int lane_rt, int col_block, int k, int slab, int tile_threads) {
  const int j = threadIdx.x % tile_threads;
  const int i = blockIdx.x * (blockDim.x / tile_threads) + threadIdx.x / tile_threads;
  const int c0 = (blockIdx.y * slab + j % slab) * W;
  if (i >= n_items || c0 >= k) return;
  const int64_t kk = k;
  const int64_t per_item = group * kk;
  const int g0 = j / slab * R;
  int t0 = i, t1 = i + 1;
  float* out = partial + i * per_item;
  if constexpr (CHUNKS) {
    t0 = __ldg(chunk_start + i);
    t1 = __ldg(chunk_start + i + 1);
    const int dest = __ldg(chunk_dest + i);
    out = dest >= 0 ? y + dest * per_item : partial + ~dest * per_item;
  }
  float acc[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[r][w] = Op::identity();
  tile_rows<LANE, W, R, Op, SKIP>(data, cols, colblock, x, t0, t1, g0, group, lane_rt,
                                  col_block, kk, c0, acc);
#pragma unroll
  for (int r = 0; r < R; ++r) store_cols<W>(out + (g0 + r) * kk + c0, acc[r]);
}

template <int W, int R, class Op, bool CHUNKS>
cudaError_t launch_rows_wr(const float* data, const int* cols, const int* colblock,
                           const int* chunk_start, const int* chunk_dest, const float* x,
                           float* partial, float* y, int n_items, int group, int lane,
                           int col_block, int k, int slab, int tile_threads, bool skip,
                           dim3 grid, int block, cudaStream_t s) {
#define HBP_LAUNCH(L)                                                                   \
  hbp_rows_kernel<L, W, R, Op, CHUNKS, SKIP><<<grid, block, 0, s>>>(                    \
      data, cols, colblock, chunk_start, chunk_dest, x, partial, y, n_items, group, lane, \
      col_block, k, slab, tile_threads)
  if constexpr (Op::kMasked) {
    if (skip) {
      constexpr bool SKIP = true;
      HBP_DISPATCH_LANE(lane, HBP_LAUNCH)
      return cudaGetLastError();
    }
  }
  constexpr bool SKIP = false;
  HBP_DISPATCH_LANE(lane, HBP_LAUNCH)
#undef HBP_LAUNCH
  return cudaGetLastError();
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}
inline bool aligned16(const void* p) { return aligned(p, 16); }

// Checks that the caller's geometry (width, rows, slab, block, grid) is
// one a tile-row kernel (hbp_rows_kernel here, the partials sum kernel of
// hbp_partials.cu) can run safely over n_items items: it covers every item
// and column, and the vector paths' pointers (y may be null) are aligned
// to the W floats a thread loads and stores (16 bytes at W = 4, 8 at
// W = 2); then selects the device.
inline cudaError_t prepare_rows(const float* data, const int* cols, const float* x,
                                const float* partial, const float* y, int n_items,
                                int group, int lane, int col_block, int k, int width,
                                int rows, int slab, int block, int grid_x, int grid_y,
                                int device) {
  if (n_items < 0 || group <= 0 || lane <= 0 || col_block <= 0 || k <= 0 || rows <= 0 ||
      group % rows != 0 || slab <= 0 || block <= 0 || block > kThreads ||
      block % (slab * (group / rows)) != 0 || grid_x < 0 || grid_y <= 0 ||
      grid_y > 65535 || !aligned16(data) || !aligned16(cols))
    return cudaErrorInvalidValue;
  const int unit = 4 * width;  // bytes of a thread's column unit
  if (width > 1 && (k % width != 0 || !aligned(x, unit) || !aligned(partial, unit) ||
                    !aligned(y, unit)))
    return cudaErrorInvalidValue;
  const int tile_threads = slab * (group / rows);
  if (static_cast<int64_t>(grid_x) * (block / tile_threads) < n_items ||
      static_cast<int64_t>(grid_y) * slab * width < k)
    return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

// Returns LAUNCH(W, R) for the columns (width) and rows a thread owns:
// float4 or scalar columns, 1 to 8 rows (the max kernels, the partials sum).
#define HBP_DISPATCH_WR(width, rows, LAUNCH) \
  switch ((width) * 16 + (rows)) {           \
    case 0x11: return LAUNCH(1, 1);          \
    case 0x12: return LAUNCH(1, 2);          \
    case 0x14: return LAUNCH(1, 4);          \
    case 0x18: return LAUNCH(1, 8);          \
    case 0x41: return LAUNCH(4, 1);          \
    case 0x42: return LAUNCH(4, 2);          \
    case 0x44: return LAUNCH(4, 4);          \
    case 0x48: return LAUNCH(4, 8);          \
    default: return cudaErrorInvalidValue;   \
  }

// The same for the fused sum, whose geometry (hbp_spmv.py
// fused_sum_geometry) also takes float2 columns and at most 2 rows.
#define HBP_DISPATCH_SUM_WR(width, rows, LAUNCH) \
  switch ((width) * 16 + (rows)) {               \
    case 0x11: return LAUNCH(1, 1);              \
    case 0x12: return LAUNCH(1, 2);              \
    case 0x21: return LAUNCH(2, 1);              \
    case 0x22: return LAUNCH(2, 2);              \
    case 0x41: return LAUNCH(4, 1);              \
    case 0x42: return LAUNCH(4, 2);              \
    default: return cudaErrorInvalidValue;       \
  }

// Launches hbp_rows_kernel over n_items items in the caller's geometry,
// checked by prepare_rows.  y is unused (may be null) unless CHUNKS.  A
// masked monoid skips masked slots' gathers where the rows of a warp are
// uniform (slab a multiple of 32).  Only the sum (unmasked) takes W = 2.
template <class Op, bool CHUNKS>
cudaError_t launch_rows(const float* data, const int* cols, const int* colblock,
                        const int* chunk_start, const int* chunk_dest, const float* x,
                        float* partial, float* y, int n_items, int group, int lane,
                        int col_block, int k, int width, int rows, int slab, int block,
                        int grid_x, int grid_y, int device, void* stream) {
  const cudaError_t ready = prepare_rows(data, cols, x, partial, y, n_items, group, lane,
                                         col_block, k, width, rows, slab, block, grid_x,
                                         grid_y, device);
  if (ready != cudaSuccess || n_items == 0) return ready;
  const int tile_threads = slab * (group / rows);
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool skip = slab % 32 == 0;  // a warp's 32 threads share their rows
#define HBP_WR(W, R)                                                                     \
  launch_rows_wr<W, R, Op, CHUNKS>(data, cols, colblock, chunk_start, chunk_dest, x,    \
                                   partial, y, n_items, group, lane, col_block, k, slab, \
                                   tile_threads, skip, grid, block, s)
  if constexpr (Op::kMasked) {
    HBP_DISPATCH_WR(width, rows, HBP_WR)
  } else {
    HBP_DISPATCH_SUM_WR(width, rows, HBP_WR)
  }
#undef HBP_WR
}

// Phase B of the chunked launches (the fused kernels of hbp_spmv.cu and
// the partials max with its run combine, hbp_partials.cu): y[rg, g, c] of
// each split run is the left fold under Op of its chunk partials in chunk
// order.  The run's chunk-buffer rows are consecutive, from
// ~chunk_dest[first chunk].
template <bool K1, class Op>
__global__ void __launch_bounds__(kThreads) hbp_fold_kernel(
    const int* __restrict__ run_chunk, const int* __restrict__ split_run,
    const int* __restrict__ chunk_dest, const int* __restrict__ run_rowgroup,
    const float* __restrict__ partial, float* __restrict__ y, int64_t n_out,
    int group, int k_rt) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int k = K1 ? 1 : k_rt;
  const int64_t per_run = static_cast<int64_t>(group) * k;
  const int64_t s = e / per_run;
  const int rem = static_cast<int>(e - s * per_run);
  const int r = __ldg(split_run + s);
  const int c0 = __ldg(run_chunk + r);
  const int n = __ldg(run_chunk + r + 1) - c0;
  const float* __restrict__ p =
      partial + static_cast<int64_t>(~__ldg(chunk_dest + c0)) * per_run + rem;
  float acc = __ldg(p);
#pragma unroll 8
  for (int j = 1; j < n; ++j) acc = Op::combine(acc, __ldg(p + j * per_run));
  y[static_cast<int64_t>(__ldg(run_rowgroup + r)) * per_run + rem] = acc;
}

}  // namespace hbp
