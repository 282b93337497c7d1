// The lane chain shared by the HBP kernels for Hopper (sm_90a).
//
// Every kernel of hbp_spmv.cu and hbp_partials.cu computes its outputs
// with tile_chain: one thread folds the slots of tiles [t0, t1), tiles in
// stream order and lanes in order, into one accumulator under a monoid:
//
//   SumOp: acc = __fmaf_rn(d, x, acc), starting from 0;
//   MaxOp: acc = fmaxf(acc, d != 0 ? __fmul_rn(d, x) : -inf), from -inf.
//
// Under MaxOp a slot is live iff its stored value is nonzero, so padded
// slots (and explicitly stored zeros) are masked to the identity instead
// of contributing 0 * x = 0, which would beat every all-negative row.
// Slot (t, g, l) reads x row colblock[t] * col_block + cols[t, g, l] of
// the row-major x [n_x, k], column c.
//
// The lane count comes at run time (the tuned configs pick 8..128): the
// common powers of two get an unrolled specialisation (LANE > 0), any
// other width the generic loop (LANE = 0).  Both run the identical chain.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace hbp {

constexpr int kThreads = 256;

struct SumOp {
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float step(float acc, float d, float xv) {
    return __fmaf_rn(d, xv, acc);
  }
};

struct MaxOp {
  static __device__ __forceinline__ float identity() { return -CUDART_INF_F; }
  static __device__ __forceinline__ float step(float acc, float d, float xv) {
    return fmaxf(acc, d != 0.0f ? __fmul_rn(d, xv) : -CUDART_INF_F);
  }
};

template <int LANE, class Op>
__device__ __forceinline__ float tile_chain(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const float* __restrict__ x,
    int t0, int t1, int g, int group, int lane_rt, int col_block, int k, int c) {
  const int lane = LANE > 0 ? LANE : lane_rt;
  float acc = Op::identity();
  for (int t = t0; t < t1; ++t) {
    const int64_t slot = (static_cast<int64_t>(t) * group + g) * lane;
    const float* __restrict__ d = data + slot;
    const int* __restrict__ cl = cols + slot;
    const float* __restrict__ xs =
        x + static_cast<int64_t>(__ldg(colblock + t)) * col_block * k + c;
#pragma unroll
    for (int l = 0; l < lane; ++l) {
      const float xv = __ldg(xs + static_cast<int64_t>(__ldg(cl + l)) * k);
      acc = Op::step(acc, __ldg(d + l), xv);
    }
  }
  return acc;
}

// Expands LAUNCH(LANE) with the specialisation for ``lane``: 8..128
// unrolled, anything else the generic loop (0).
#define HBP_DISPATCH_LANE(lane, LAUNCH) \
  switch (lane) {                       \
    case 8: LAUNCH(8); break;           \
    case 16: LAUNCH(16); break;         \
    case 32: LAUNCH(32); break;         \
    case 64: LAUNCH(64); break;         \
    case 128: LAUNCH(128); break;       \
    default: LAUNCH(0); break;          \
  }

// Checks the sizes of a launch over n_out output elements and makes the
// operands' device current; returns cudaSuccess with the grid in *grid,
// or the error to hand back to the caller.
inline cudaError_t prepare_launch(int64_t n_out, int group, int lane, int col_block,
                                  int k, int device, dim3* grid) {
  if (n_out < 0 || group <= 0 || lane <= 0 || col_block <= 0 || k <= 0)
    return cudaErrorInvalidValue;
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *grid = dim3(static_cast<unsigned>(blocks));
  // the caller's stream belongs to the operands' device; make it current
  // for this library's runtime before launching into it
  return cudaSetDevice(device);
}

}  // namespace hbp
