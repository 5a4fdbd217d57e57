// Closest-hit ray x triangle test over a Morton-ordered packed table.
//
// Replaces the Pallas TPU kernel statmc_tpu/accel/fused.py:_kernel
// (launched by _intersect_pallas).  Same table layout and semantics:
//   edge_table  [n_tiles, 3, 256, 8]  rows [a x b, b - a, 0, 0] per edge,
//   plane_table [n_tiles, 2, 256, 8]  numerator row [0,0,0, -n, n.v0, 0]
//                                     and denominator row [n, 0...],
//   ray rows    raye [R, 8] = [d, o x d, 0, 0], rayp [R, 8] = [d, o, 1, 0].
// Per (ray, triangle): w_k = edge_k . raye, num/den = plane . rayp;
// inside = all w_k >= 0 or all w_k <= 0; t = num/den when |den| > 1e-12;
// kept when t > 1e-4 and t < best (strict, so the earlier packed id wins
// ties).  A miss keeps t = t_max and id = -1.
//
// What bounds it on the H100: arithmetic.  Each pair costs 5 eight-term
// dot products (40 mul + 35 add) plus the epilogue, against 160 bytes of
// table per triangle that every ray of a block shares.  The TPU kernel
// ran these dots as small-K matmuls on the MXU; here they are scalar FP32
// on the CUDA cores, which is simple and exact to reproduce.
//
// Design: one thread per ray, 256 threads per block.  The block walks
// the triangle tiles in packed order; each 256-triangle tile (40 KB) is
// staged once through shared memory and read by all 256 rays as
// broadcasts.  Each dot is one explicit fused multiply-add chain in
// column order (__fmaf_rn), the same chain the plain PyTorch version
// (accel/fused.py) evaluates exactly in float64 and rounds per step, so
// the two agree bit for bit.  A block whose rays all have t_max <= 0 (dead lanes)
// skips the walk: such a lane can never improve, so the skip is exact.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // triangles per tile (accel/fused.py TRI_TILE)
constexpr int kK = 8;       // feature columns per row
constexpr int kRows = 5;    // 3 edge rows + 2 plane rows per triangle

// acc = fma(a[c], b[c], acc) for c = 0..7 from acc = 0: the column
// order and rounding of the plain version (and of XLA's CPU dot).
__device__ __forceinline__ float dot8(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kK; ++c) s = __fmaf_rn(a[c], b[c], s);
  return s;
}

__global__ void __launch_bounds__(kTile)
fused_intersect_kernel(const float* __restrict__ raye,
                       const float* __restrict__ rayp,
                       const float* __restrict__ t_max,
                       const float* __restrict__ edge,
                       const float* __restrict__ plane, int n_rays,
                       int n_tiles, float* __restrict__ t_out,
                       int* __restrict__ id_out) {
  __shared__ float tile[kRows * kTile * kK];  // [5][256][8], 40 KB
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = ray < n_rays;

  float re[kK], rp[kK];
  float best_t = 0.0f;
  int best_id = -1;
  if (in_range) {
#pragma unroll
    for (int c = 0; c < kK; ++c) {
      re[c] = raye[ray * kK + c];
      rp[c] = rayp[ray * kK + c];
    }
    best_t = t_max[ray];
  }
  const bool live = in_range && best_t > 0.0f;
  if (__syncthreads_or(live)) {
    for (int j = 0; j < n_tiles; ++j) {
      // Stage tile j: 3 edge rows then 2 plane rows, each [256][8].
      const float* e = edge + (size_t)j * 3 * kTile * kK;
      const float* p = plane + (size_t)j * 2 * kTile * kK;
      for (int i = threadIdx.x; i < 3 * kTile * kK; i += blockDim.x)
        tile[i] = e[i];
      for (int i = threadIdx.x; i < 2 * kTile * kK; i += blockDim.x)
        tile[3 * kTile * kK + i] = p[i];
      __syncthreads();
      if (live) {
        for (int k = 0; k < kTile; ++k) {
          const float w0 = dot8(&tile[(0 * kTile + k) * kK], re);
          const float w1 = dot8(&tile[(1 * kTile + k) * kK], re);
          const float w2 = dot8(&tile[(2 * kTile + k) * kK], re);
          const float num = dot8(&tile[(3 * kTile + k) * kK], rp);
          const float den = dot8(&tile[(4 * kTile + k) * kK], rp);
          const bool inside = (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f) ||
                              (w0 <= 0.0f && w1 <= 0.0f && w2 <= 0.0f);
          const float t = fabsf(den) > 1e-12f ? __fdiv_rn(num, den) : 1e30f;
          const float tc = (inside && t > 1e-4f) ? t : 1e30f;
          if (tc < best_t) {
            best_t = tc;
            best_id = j * kTile + k;
          }
        }
      }
      __syncthreads();
    }
  }
  if (in_range) {
    t_out[ray] = best_t;
    id_out[ray] = best_id;
  }
}

}  // namespace

extern "C" int statmc_fused_intersect(const float* raye, const float* rayp,
                                      const float* t_max, const float* edge,
                                      const float* plane, int n_rays,
                                      int n_tiles, float* t_out, int* id_out,
                                      void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kTile - 1) / kTile;
    fused_intersect_kernel<<<blocks, kTile, 0, (cudaStream_t)stream>>>(
        raye, rayp, t_max, edge, plane, n_rays, n_tiles, t_out, id_out);
  }
  return (int)cudaGetLastError();
}
