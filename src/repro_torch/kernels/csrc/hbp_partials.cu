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
// run of tiles) is the caller's.
//
// Design.
// * One thread per output element (t, g, c), flattened with c fastest as
//   in the fused kernels: every tile is independent, so there is no run
//   walk, and the power-law hub runs that one thread of the fused kernels
//   walks end to end are spread over as many threads as they have tiles.
// * The chain is the fused kernels' own (hbp_chain.cuh) over one tile, and
//   SpMV is the template at k = 1, so each partial of SpMV(x) is bitwise
//   equal to column c of the SpMM partials whenever X[:, c] = x; with a
//   width-invariant combine the served answers are too.
// * Every element of the partials buffer is written: the caller allocates
//   it uninitialised.
//
// Bound on this card: bytes, as for the fused kernels (the same tile
// stream, x and y), plus the partials buffer: n_tiles * group * k * 4
// bytes written here and read back by the combine.  That buffer is the
// price of the split; it is what the fused kernels keep out of memory.

#include "hbp_chain.cuh"

namespace {

using hbp::kThreads;

// K1 = true is the SpMV entry: k fixed at 1, otherwise the same code.
template <int LANE, bool K1, class Op>
__global__ void __launch_bounds__(kThreads) hbp_partials_kernel(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const float* __restrict__ x,
    float* __restrict__ partial, int64_t n_out, int group, int lane, int col_block,
    int k_rt) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int k = K1 ? 1 : k_rt;
  const int64_t per_tile = static_cast<int64_t>(group) * k;
  const int t = static_cast<int>(e / per_tile);
  const int rem = static_cast<int>(e - t * per_tile);
  const int g = rem / k;
  const int c = rem - g * k;
  partial[e] = hbp::tile_chain<LANE, Op>(data, cols, colblock, x, t, t + 1, g, group,
                                         lane, col_block, k, c);
}

template <bool K1, class Op>
int launch(const float* data, const int* cols, const int* colblock, const float* x,
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
  hbp_partials_kernel<L, K1, Op><<<grid, kThreads, 0, s>>>(                   \
      data, cols, colblock, x, partial, n_out, group, lane, col_block, k)
  HBP_DISPATCH_LANE(lane, HBP_LAUNCH)
#undef HBP_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// partial: f32[n_tiles, group]; x: f32[n_x].
int hbp_spmv_partials_launch(const float* data, const int* cols, const int* colblock,
                             const float* x, float* partial, int n_tiles, int group,
                             int lane, int col_block, int device, void* stream) {
  return launch<true, hbp::SumOp>(data, cols, colblock, x, partial, n_tiles, group,
                                  lane, col_block, 1, device, stream);
}

// partial: f32[n_tiles, group, k]; x: f32[n_x, k].
int hbp_spmm_partials_launch(const float* data, const int* cols, const int* colblock,
                             const float* x, float* partial, int n_tiles, int group,
                             int lane, int col_block, int k, int device,
                             void* stream) {
  return launch<false, hbp::SumOp>(data, cols, colblock, x, partial, n_tiles, group,
                                   lane, col_block, k, device, stream);
}

// partial: f32[n_tiles, group, k], -inf where a tile row has no live slot.
int hbp_spmm_partials_max_launch(const float* data, const int* cols,
                                 const int* colblock, const float* x, float* partial,
                                 int n_tiles, int group, int lane, int col_block,
                                 int k, int device, void* stream) {
  return launch<false, hbp::MaxOp>(data, cols, colblock, x, partial, n_tiles, group,
                                   lane, col_block, k, device, stream);
}

}  // extern "C"
