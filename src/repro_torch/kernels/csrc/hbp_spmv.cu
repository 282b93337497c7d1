// Fused-combine HBP SpMV and SpMM for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/hbp_spmv.py:
//   hbp_spmv_fused_launch  <- _fused_kernel / hbp_spmv_fused
//   hbp_spmm_fused_launch  <- _fused_spmm_kernel / hbp_spmm_fused
// Both compute, in hashed row order,
//   y[rg, g, c] = sum over the tiles t of row group rg (stream order)
//                 sum over lanes l = 0 .. lane-1 (in order)
//                 data[t, g, l] * x[colblock[t] * col_block + cols[t, g, l], c]
// with x row-major [n_x, k] (k = 1 for SpMV) and y row-major
// [n_rowgroups, group, k].
//
// Design.
// * Runs replace the sequential grid.  The TPU kernel accumulates into an
//   output block across consecutive grid steps; GPU blocks run in no order.
//   Tiles are sorted by (rowgroup, colblock), so each row group owns one
//   contiguous run [run_start[r], run_start[r + 1]).  One thread owns one
//   output element (r, g, c) of one run and writes it once: no atomics.
//   Row groups without tiles are never written; the caller's zero-filled
//   output covers them.
// * One accumulation order for every width.  Each output is a single
//   __fmaf_rn chain over the run's tiles in stream order and lanes in
//   order, starting from 0.  SpMV is the same template at k = 1, so SpMV(x)
//   is bitwise equal to column c of SpMM(X) whenever X[:, c] = x, at any k
//   and any zero padding of k: a batched serving answer equals the
//   one-vector answer.
// * Output elements are flattened as (run, g, c), c fastest: for small k
//   several runs share one block of threads (SpMV packs 32 runs per
//   block), for wide k one run spans several blocks, and neighbouring
//   threads read neighbouring columns of an x row.
// * The lane count comes at run time (the tuned configs pick 8..128): the
//   common powers of two get an unrolled specialisation, any other width
//   the generic loop.  Both run the identical chain.
//
// Bound on this card: bytes.  Each stored slot costs 8 bytes of tile
// stream (value + column id) for 2 flops per column of x; even at k = 128
// the tile stream plus x and y take about as long to move as the fmas
// take to issue, and below that the memory side dominates.  x is read
// straight from global memory: its rows are re-read by every tile that
// touches them and mostly hit the 50 MB L2.  A single long run (a
// power-law hub row group) serialises inside one thread; splitting such
// runs, staging x segments in shared memory and widening the loads are
// left to measured follow-up work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int LANE>
__device__ __forceinline__ float run_chain(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const float* __restrict__ x,
    int t0, int t1, int g, int group, int lane_rt, int col_block, int k, int c) {
  const int lane = LANE > 0 ? LANE : lane_rt;
  float acc = 0.0f;
  for (int t = t0; t < t1; ++t) {
    const int64_t slot = (static_cast<int64_t>(t) * group + g) * lane;
    const float* __restrict__ d = data + slot;
    const int* __restrict__ cl = cols + slot;
    const float* __restrict__ xs =
        x + static_cast<int64_t>(__ldg(colblock + t)) * col_block * k + c;
#pragma unroll
    for (int l = 0; l < lane; ++l) {
      const float xv = __ldg(xs + static_cast<int64_t>(__ldg(cl + l)) * k);
      acc = __fmaf_rn(__ldg(d + l), xv, acc);
    }
  }
  return acc;
}

// K1 = true is the SpMV entry: k fixed at 1, otherwise the same code.
template <int LANE, bool K1>
__global__ void __launch_bounds__(kThreads) hbp_fused_kernel(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const int* __restrict__ run_start,
    const int* __restrict__ run_rowgroup, const float* __restrict__ x,
    float* __restrict__ y, int64_t n_out, int group, int lane, int col_block,
    int k_rt) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int k = K1 ? 1 : k_rt;
  const int64_t per_run = static_cast<int64_t>(group) * k;
  const int64_t r = e / per_run;
  const int rem = static_cast<int>(e - r * per_run);
  const int g = rem / k;
  const int c = rem - g * k;
  const float acc = run_chain<LANE>(data, cols, colblock, x, __ldg(run_start + r),
                                    __ldg(run_start + r + 1), g, group, lane,
                                    col_block, k, c);
  y[(static_cast<int64_t>(__ldg(run_rowgroup + r)) * group + g) * k + c] = acc;
}

template <bool K1>
int launch(const float* data, const int* cols, const int* colblock,
           const int* run_start, const int* run_rowgroup, const float* x,
           float* y, int n_runs, int group, int lane, int col_block, int k,
           int device, void* stream) {
  if (n_runs < 0 || group <= 0 || lane <= 0 || col_block <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_out = static_cast<int64_t>(n_runs) * group * k;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the caller's stream belongs to the operands' device; make it current
  // for this library's runtime before launching into it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HBP_LAUNCH(L)                                                        \
  hbp_fused_kernel<L, K1><<<grid, kThreads, 0, s>>>(                         \
      data, cols, colblock, run_start, run_rowgroup, x, y, n_out, group, lane, \
      col_block, k)
  switch (lane) {
    case 8: HBP_LAUNCH(8); break;
    case 16: HBP_LAUNCH(16); break;
    case 32: HBP_LAUNCH(32); break;
    case 64: HBP_LAUNCH(64); break;
    case 128: HBP_LAUNCH(128); break;
    default: HBP_LAUNCH(0); break;
  }
#undef HBP_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y: f32[n_rowgroups, group], zero-filled by the caller; x: f32[n_x].
int hbp_spmv_fused_launch(const float* data, const int* cols, const int* colblock,
                          const int* run_start, const int* run_rowgroup,
                          const float* x, float* y, int n_runs, int group,
                          int lane, int col_block, int device, void* stream) {
  return launch<true>(data, cols, colblock, run_start, run_rowgroup, x, y, n_runs,
                      group, lane, col_block, 1, device, stream);
}

// y: f32[n_rowgroups, group, k], zero-filled by the caller; x: f32[n_x, k].
int hbp_spmm_fused_launch(const float* data, const int* cols, const int* colblock,
                          const int* run_start, const int* run_rowgroup,
                          const float* x, float* y, int n_runs, int group,
                          int lane, int col_block, int k, int device,
                          void* stream) {
  return launch<false>(data, cols, colblock, run_start, run_rowgroup, x, y, n_runs,
                       group, lane, col_block, k, device, stream);
}

}  // extern "C"
