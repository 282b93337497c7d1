// The lane chains shared by the HBP kernels for Hopper (sm_90a).
//
// Every output element is a fold, under a monoid, of the slots of a range
// of tiles [t0, t1), tiles in stream order and lanes in order:
//
//   SumOp: acc = __fmaf_rn(d, x, acc), starting from 0;
//   MaxOp: acc = max_nan(acc, d != 0 ? __fmul_rn(d, x) : -inf), from -inf.
//
// Under MaxOp a slot is live iff its stored value is nonzero, so padded
// slots (and explicitly stored zeros) are masked to the identity instead
// of contributing 0 * x = 0, which would beat every all-negative row; the
// mask comes first, so a masked slot is the identity whatever x holds
// (the JAX package's jnp.where(d != 0, d * x, -inf)).  A NaN product of a
// live slot, or a NaN accumulator, gives NaN, as jnp.max does: max_nan is
// PTX max.NaN.f32, where fmaxf would return the other operand and drop
// the NaN.  On operands that are not NaN the two give the same bits.
// max.NaN.f32 ranks +0.0 above -0.0 in either order (IEEE's maximum, as
// jnp.maximum does; the signed-zero probe of chip_smoke.py checks it on the
// card), so no step or fold here depends on operand order for the sign of
// a zero.
// Slot (t, g, l) reads x row colblock[t] * col_block + cols[t, g, l] of
// the row-major x [n_x, k], column c.
//
// The lane count comes at run time (the tuned configs pick 8..128): the
// common powers of two get an unrolled specialisation (LANE > 0), any
// other width the generic loop (LANE = 0).  Both run the identical chain.
//
// scalar_sum_chain and vec_sum_chain are the SumOp chains of the fused
// SpMV (hbp_spmv.cu, kernel 1), one (chunk, row) a thread: the same
// multiply-adds in the same order, so the same bits; vec_sum_chain (LANE
// > 0) reads each tile row as 16-byte vectors and loads the next step's
// row while this step's x gathers are in flight.  The SpMM kernels and
// the partials kernels give a thread several rows and columns of a tile
// range instead (hbp_rows.cuh, hbp_partials.cu), in the same order of
// multiply-adds; at k = 1 that walk took 10 % more device time than
// these chains on m4_kron16 (PERF.md), so the SpMV keeps them.  x's row
// stride k and column c are run-time arguments though kernel 1 passes 1
// and 0: with k a compile-time 1 the same chain took 0.044 ms a launch on
// m4_kron16 against 0.038 (H100 SXM, 700 W; PERF.md), with the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace hbp {

constexpr int kThreads = 256;

// max(a, b), NaN once either is NaN (max.NaN.f32, sm_80 and later).
__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else  // the host compiler's view of a device function
  return a != a || b != b ? a + b : fmaxf(a, b);
#endif
}

// step folds one slot into an accumulator; combine folds two partial
// results of one output (the split runs' fold).  kMasked: a slot whose
// stored value is 0 is the identity, so its x gather can be skipped.
struct SumOp {
  static constexpr bool kMasked = false;
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float step(float acc, float d, float xv) {
    return __fmaf_rn(d, xv, acc);
  }
  static __device__ __forceinline__ float combine(float a, float b) { return __fadd_rn(a, b); }
};

struct MaxOp {
  static constexpr bool kMasked = true;
  static __device__ __forceinline__ float identity() { return -CUDART_INF_F; }
  static __device__ __forceinline__ float step(float acc, float d, float xv) {
    return max_nan(acc, d != 0.0f ? __fmul_rn(d, xv) : -CUDART_INF_F);
  }
  static __device__ __forceinline__ float combine(float a, float b) { return max_nan(a, b); }
};

// The SumOp chain of tiles [t0, t1) for row g, column c, any lane count.
__device__ __forceinline__ float scalar_sum_chain(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const float* __restrict__ x,
    int t0, int t1, int g, int group, int lane, int col_block, int k, int c) {
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

// Lanes per step of vec_sum_chain: two 16-byte loads each of cols and data.
constexpr int kStep = 8;

template <int LANE>
__device__ __forceinline__ float vec_sum_chain(
    const float* __restrict__ data, const int* __restrict__ cols,
    const int* __restrict__ colblock, const float* __restrict__ x,
    int t0, int t1, int g, int group, int col_block, int k, int c) {
  static_assert(LANE >= kStep && LANE % kStep == 0, "lane must be a multiple of 8");
  constexpr int kSteps = LANE / kStep;  // steps per tile row
  struct Row {
    int4 c0, c1;
    float4 d0, d1;
    const float* xs;  // column c of the tile's x segment
  };
  // step s reads lanes [j * kStep, (j + 1) * kStep) of row g of tile t
  auto fetch = [&](int s) {
    const int t = t0 + s / kSteps;
    const int j = s % kSteps;
    const int64_t slot = (static_cast<int64_t>(t) * group + g) * LANE + j * kStep;
    const int4* cp = reinterpret_cast<const int4*>(cols + slot);
    const float4* dp = reinterpret_cast<const float4*>(data + slot);
    Row r;
    r.c0 = __ldg(cp);
    r.c1 = __ldg(cp + 1);
    r.d0 = __ldg(dp);
    r.d1 = __ldg(dp + 1);
    r.xs = x + static_cast<int64_t>(__ldg(colblock + t)) * col_block * k + c;
    return r;
  };
  const int n = (t1 - t0) * kSteps;
  float acc = 0.0f;
  if (n <= 0) return acc;
  Row cur = fetch(0);
  for (int s = 0; s < n; ++s) {
    const float* xs = cur.xs;
    const int64_t kk = k;
    const float x0 = __ldg(xs + cur.c0.x * kk), x1 = __ldg(xs + cur.c0.y * kk);
    const float x2 = __ldg(xs + cur.c0.z * kk), x3 = __ldg(xs + cur.c0.w * kk);
    const float x4 = __ldg(xs + cur.c1.x * kk), x5 = __ldg(xs + cur.c1.y * kk);
    const float x6 = __ldg(xs + cur.c1.z * kk), x7 = __ldg(xs + cur.c1.w * kk);
    // the last step re-reads its own row rather than branch
    const Row next = fetch(s + 1 < n ? s + 1 : s);
    acc = __fmaf_rn(cur.d0.x, x0, acc);
    acc = __fmaf_rn(cur.d0.y, x1, acc);
    acc = __fmaf_rn(cur.d0.z, x2, acc);
    acc = __fmaf_rn(cur.d0.w, x3, acc);
    acc = __fmaf_rn(cur.d1.x, x4, acc);
    acc = __fmaf_rn(cur.d1.y, x5, acc);
    acc = __fmaf_rn(cur.d1.z, x6, acc);
    acc = __fmaf_rn(cur.d1.w, x7, acc);
    cur = next;
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

// One thread per output element: the grid of kThreads-wide blocks that
// covers n_out >= 0 elements.
inline cudaError_t grid_for(int64_t n_out, dim3* grid) {
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *grid = dim3(static_cast<unsigned>(blocks));
  return cudaSuccess;
}

// Checks the sizes of a launch over n_out output elements and makes the
// operands' device current; returns cudaSuccess with the grid in *grid,
// or the error to hand back to the caller.
inline cudaError_t prepare_launch(int64_t n_out, int group, int lane, int col_block,
                                  int device, dim3* grid) {
  if (n_out < 0 || group <= 0 || lane <= 0 || col_block <= 0)
    return cudaErrorInvalidValue;
  const cudaError_t sized = grid_for(n_out, grid);
  if (sized != cudaSuccess) return sized;
  // the caller's stream belongs to the operands' device; make it current
  // for this library's runtime before launching into it
  return cudaSetDevice(device);
}

}  // namespace hbp
