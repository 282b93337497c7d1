// The sampled dense-dense product (SDDMM) of GAT's attention gradient, for
// Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package has no GAT.  It is the gradient
// of the attention weights in repro_torch.kernels.autodiff (the port's
// GAT, graph/layers_gnn.py): for every stored entry e = (i, j) of a CSR
// matrix (row = destination) and every head h,
//   out[e, h] = sum over c < head_dim of dy[i, h * head_dim + c] * z[j, h * head_dim + c]
// with dy and z row-major [n, heads * head_dim] and out row-major [nnz, heads].
// Its plain version is repro_torch.kernels.ref.sddmm.
//
// Design.
// * The walk: one warp per chunk of per_warp consecutive CSR entries, not
//   one warp per row.  R-MAT's hub rows hold thousands of entries and most
//   rows a few, so a warp per row would leave a few warps walking hubs long
//   after the rest finished; a chunk of entries bounds every warp's walk,
//   and a hub row is split over as many warps as it has chunks.  A warp
//   finds the row of its first entry by a binary search of indptr and steps
//   to the next row (past empty rows) as its entries cross row ends, so it
//   needs no row index beside the CSR.
// * One entry at a time: the warp's 32 lanes stride over a head's
//   head_dim columns (neighbouring lanes on neighbouring addresses of one
//   z row and one dy row), each lane one __fmaf_rn chain in column order,
//   then a butterfly of __shfl_xor_sync adds the lanes' sums in a fixed
//   order.  The result does not depend on the launch: the same bits for
//   the same inputs.
// * dy's row is reread for each entry of the row and mostly hits L1; each
//   entry gathers one z row of heads * head_dim floats.
//
// Bound on this card: bytes.  The work model (h100bench/work/gat.py) counts
// the CSR, dy and z read once and out written once, 2 * nnz * heads *
// head_dim operations: about 0.15 ms for GAT's hidden layers on the kron16
// graph.  The kernel moves far more: each entry's z row, 3,000 bytes at
// heads 3 and head_dim 250, is read again for every entry of its column,
// from L2 where it hits (z is 197 MB there, four times L2).  Staging the
// rows that a tile of entries shares, or walking the HBP tiles' column
// blocks, is left to measured follow-up work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

__global__ void __launch_bounds__(kThreads) hbp_sddmm_kernel(
    const long long* __restrict__ indptr, const int* __restrict__ cols,
    const float* __restrict__ dy, const float* __restrict__ z, float* __restrict__ out,
    int n_rows, int nnz, int heads, int head_dim, int per_warp) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t e0 = warp * per_warp;
  if (e0 >= nnz) return;  // whole warps leave together: the shuffles below see all 32
  const int64_t e1 = e0 + per_warp < nnz ? e0 + per_warp : nnz;
  // the row of e0: indptr[row] <= e0 < indptr[row + 1]
  int lo = 0, hi = n_rows;
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(indptr + mid) <= e0) lo = mid;
    else hi = mid;
  }
  int row = lo;
  const int64_t width = static_cast<int64_t>(heads) * head_dim;
  for (int64_t e = e0; e < e1; ++e) {
    while (__ldg(indptr + row + 1) <= e) ++row;
    const float* dy_row = dy + static_cast<int64_t>(row) * width;
    const float* z_row = z + static_cast<int64_t>(__ldg(cols + e)) * width;
    for (int h = 0; h < heads; ++h) {
      const float* a = dy_row + static_cast<int64_t>(h) * head_dim;
      const float* b = z_row + static_cast<int64_t>(h) * head_dim;
      float acc = 0.0f;
#pragma unroll 4
      for (int c = lane; c < head_dim; c += kWarp)
        acc = __fmaf_rn(__ldg(a + c), __ldg(b + c), acc);
#pragma unroll
      for (int offset = kWarp / 2; offset > 0; offset /= 2)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, offset));
      if (lane == 0) out[e * heads + h] = acc;
    }
  }
}

}  // namespace

extern "C" {

// indptr: i64[n_rows + 1] (long long, which __ldg takes); cols: i32[nnz],
// each below z's rows; dy, z: f32[n, heads * head_dim]; out: f32[nnz,
// heads], uninitialised (every element is written).  per_warp: CSR entries
// a warp walks.
int hbp_sddmm_launch(const long long* indptr, const int* cols, const float* dy,
                     const float* z, float* out, int n_rows, int nnz, int heads,
                     int head_dim, int per_warp, int device, void* stream) {
  if (n_rows <= 0 || nnz < 0 || heads <= 0 || head_dim <= 0 || per_warp <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nnz == 0) return static_cast<int>(cudaSuccess);
  const int64_t warps = (static_cast<int64_t>(nnz) + per_warp - 1) / per_warp;
  const int64_t blocks = (warps * kWarp + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  hbp_sddmm_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      indptr, cols, dy, z, out, n_rows, nnz, heads, head_dim, per_warp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
