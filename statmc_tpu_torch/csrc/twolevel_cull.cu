// Kernel B3: per-block subgroup cull of the two-level traversal.
//
// Replaces the Pallas TPU kernel statmc_tpu/accel/twolevel.py:
// _worklist_kernel (launched by _votes_pallas).  Same semantics as the
// plain version accel/twolevel.py:cull_plain:
//   bounds [nf, 8]        fine subgroup AABBs (lo xyz, hi xyz, pad 2),
//   rays   [G, 512, 8]    per ray o xyz, inverse d xyz, t_max, pad,
//   vote   [G, nf] uint8  1 when some ray of block g enters box j within
//                         (0, t_max]:  per axis t0 = (lo - o) * inv,
//                         t1 = (hi - o) * inv; tn = max of the per-axis
//                         mins, tf = min(t_max, the per-axis maxes);
//                         vote = tn <= tf * 1.0001 and tf > 0.
// The test is elementwise (no sum whose order could differ), so the
// votes equal the plain version's bit for bit.  NaN included: the min and
// max propagate a NaN as torch.minimum/maximum do (PTX min.NaN/max.NaN),
// so a ray whose slab times hold a NaN never votes, in either version.
//
// What bounds it on the H100: arithmetic.  Each (ray, box) test is ~20
// FP32 operations against 32 bytes of ray that all boxes of a block
// share; the worst case at 921,600 rays x 4,112 subgroups is ~7.6e10
// operations (~1.1 ms at 67 TFLOP/s).  The vote is an OR, so a thread
// stops at the first ray that enters its box, and the work actually done
// depends on the rays.
//
// Design: one block per (512-ray block g, chunk of 128 subgroups), one
// thread per subgroup with its box in registers.  The block stages its
// 512 rays (16 KB) in shared memory once; every thread sweeps them in
// order, all reading the same ray at a time (a broadcast), and stops at
// its first vote.  Dead rays (t_max <= 0, or NaN) can never vote and are
// skipped; a block whose rays are all dead writes zeros and stops.
#include <cuda_runtime.h>

namespace {

constexpr int kRT = 512;    // rays per block (accel/twolevel.py RT_WALK)
constexpr int kChunk = 128; // subgroups per CUDA block

// NaN-propagating min/max, the semantics of torch.minimum/maximum
// (fminf/fmaxf would drop a NaN operand and let the ray vote).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void __launch_bounds__(kChunk)
twolevel_cull_kernel(const float* __restrict__ bounds,
                     const float* __restrict__ rays, int nf,
                     unsigned char* __restrict__ vote) {
  // Per ray two float4: (ox, oy, oz, ivx), (ivy, ivz, t_max, pad).
  __shared__ float4 ray_s[2 * kRT];
  const int g = blockIdx.y;
  const int j = blockIdx.x * kChunk + threadIdx.x;
  const float4* src =
      reinterpret_cast<const float4*>(rays) + (size_t)g * 2 * kRT;
  bool live = false;
  for (int i = threadIdx.x; i < 2 * kRT; i += kChunk) {
    const float4 v = src[i];
    ray_s[i] = v;
    if (i & 1) live = live || v.z > 0.0f;
  }
  const bool any_live = __syncthreads_or(live);
  if (j >= nf) return;
  unsigned char v = 0;
  if (any_live) {
    const float* b = bounds + (size_t)j * 8;
    const float lx = b[0], ly = b[1], lz = b[2];
    const float hx = b[3], hy = b[4], hz = b[5];
    for (int r = 0; r < kRT; ++r) {
      const float4 a = ray_s[2 * r];
      const float4 c = ray_s[2 * r + 1];
      if (!(c.z > 0.0f)) continue;  // dead ray: tf <= t_max <= 0
      float t0 = (lx - a.x) * a.w;
      float t1 = (hx - a.x) * a.w;
      float tn = min_nan(t0, t1);
      float tf = max_nan(t0, t1);
      t0 = (ly - a.y) * c.x;
      t1 = (hy - a.y) * c.x;
      tn = max_nan(tn, min_nan(t0, t1));
      tf = min_nan(tf, max_nan(t0, t1));
      t0 = (lz - a.z) * c.y;
      t1 = (hz - a.z) * c.y;
      tn = max_nan(tn, min_nan(t0, t1));
      tf = min_nan(tf, max_nan(t0, t1));
      tf = min_nan(tf, c.z);
      if (tn <= __fmul_rn(tf, 1.0001f) && tf > 0.0f) {
        v = 1;
        break;
      }
    }
  }
  vote[(size_t)g * nf + j] = v;
}

}  // namespace

extern "C" int statmc_twolevel_cull(const float* bounds, const float* rays,
                                    int n_blocks, int nf, unsigned char* vote,
                                    void* stream) {
  if (n_blocks > 0 && nf > 0) {
    const dim3 grid((nf + kChunk - 1) / kChunk, n_blocks);
    twolevel_cull_kernel<<<grid, kChunk, 0, (cudaStream_t)stream>>>(
        bounds, rays, nf, vote);
  }
  return (int)cudaGetLastError();
}
