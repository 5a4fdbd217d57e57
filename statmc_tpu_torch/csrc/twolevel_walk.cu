// Kernel B4: worklist walk of the two-level traversal.
//
// Replaces the Pallas TPU kernel statmc_tpu/accel/twolevel.py:_kernel
// (launched by _walk_pallas).  Same semantics as the plain version
// accel/twolevel.py:walk_plain:
//   table [nst, 16, 640]  per 128-triangle subtile, rows pair with the ray
//                         features [d, o x d, o, 1, 0...]; columns are the
//                         five forms [w0|w1|w2|num|den] x 128 triangles,
//   order [G, 384] int32  block g's worklist in ascending subtile id,
//   count [G] int32       its length; count > 384 means "walk every
//                         subtile densely and ignore the mask",
//   mask  [G, nw] int32   bit f of the block's words: fine subgroup f
//                         (32 triangles when fsub = 4) may be hit,
//   feat  [G, 16, 512]    the block's ray features, t_max [G, 512],
//   t/id  [G, 512]        closest hit; a miss keeps t_max and id -1.
// Per (ray, triangle): the five forms are FMA chains over the feature
// rows in row order from 0 (__fmaf_rn), skipping the rows that the table
// layout leaves zero (w: rows 0-5, num: rows 6-9, den: rows 0-2; a zero
// row only changes the sign of a zero, which no comparison reads);
// inside = all w >= 0 or all w <= 0; t = num / den when |den| > 1e-12,
// else 1e30; a candidate is t when inside and t > 1e-4, else 1e30; it
// wins when < best (strict, in ascending id: the smallest id wins ties).
// The plain version forms the same chains exactly in float64, rounding
// each step to float32, so the two agree bit for bit.
//
// What bounds it on the H100: arithmetic.  Each requested (ray,
// triangle) pair costs 25 FMAs plus ~15 epilogue operations against
// 20 bytes of table that all 512 rays of a block share.  How many pairs
// are requested depends on the worklists and submasks (chip_smoke.py
// counts them for its inputs).
//
// Design: one CUDA block per 512-ray block, one thread per ray with its
// ten feature values in registers.  The block walks its worklist; each
// subtile's ten non-zero rows (25.6 KB) are staged once in shared memory
// and read by all rays as broadcasts, 16 bytes (four triangles' values
// of one row) per load.  The submask bit of a subgroup is
// the same for every thread of the block, so skipping a gated subgroup
// is a uniform branch.  A block with an empty worklist does no work.
#include <cuda_runtime.h>

namespace {

constexpr int kST = 128;         // triangles per subtile
constexpr int kRT = 512;         // rays per block
constexpr int kMaxS = 384;       // worklist slots (accel/twolevel.py MAXS)
constexpr int kCols = 5 * kST;   // table columns
constexpr int kRows = 10;        // feature rows that can be non-zero
constexpr int kTableRows = 16;   // feature rows in the table

constexpr int kCols4 = kCols / 4;

// For four adjacent columns c4*4 .. c4*4+3 at once (one 16-byte shared
// load per row): acc = fma(tab[row][col], f[row], acc) for row = lo..hi-1
// from acc = 0.
template <int lo, int hi>
__device__ __forceinline__ float4 chain4(const float4* tab4, int c4,
                                         const float* f) {
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = lo; k < hi; ++k) {
    const float4 a = tab4[k * kCols4 + c4];
    s.x = __fmaf_rn(a.x, f[k], s.x);
    s.y = __fmaf_rn(a.y, f[k], s.y);
    s.z = __fmaf_rn(a.z, f[k], s.z);
    s.w = __fmaf_rn(a.w, f[k], s.w);
  }
  return s;
}

// The epilogue of one (ray, triangle) pair.
__device__ __forceinline__ void consider(float w0, float w1, float w2,
                                         float num, float den, int id,
                                         float& best_t, int& best_id) {
  const float wmin = fminf(fminf(w0, w1), w2);
  const float wmax = fmaxf(fmaxf(w0, w1), w2);
  const bool inside = wmin >= 0.0f || wmax <= 0.0f;
  const float t = fabsf(den) > 1e-12f ? __fdiv_rn(num, den) : 1e30f;
  const float tc = (inside && t > 1e-4f) ? t : 1e30f;
  if (tc < best_t) {
    best_t = tc;
    best_id = id;
  }
}

__global__ void __launch_bounds__(kRT)
twolevel_walk_kernel(const float* __restrict__ table,
                     const int* __restrict__ order,
                     const int* __restrict__ count,
                     const int* __restrict__ mask, int n_words,
                     const float* __restrict__ feat,
                     const float* __restrict__ t_max, int fsub,
                     float* __restrict__ t_out, int* __restrict__ id_out) {
  __shared__ float4 tab4[kRows * kCols4];  // rows 0-9 of one subtile
  const int g = blockIdx.x;
  const int r = threadIdx.x;
  float f[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    f[k] = feat[((size_t)g * kTableRows + k) * kRT + r];
  float best_t = t_max[(size_t)g * kRT + r];
  int best_id = -1;
  const int n = count[g];
  const bool dense = n > kMaxS;
  const int stf = kST / fsub;
  const unsigned* words = reinterpret_cast<const unsigned*>(mask) +
                          (size_t)g * n_words;

  for (int k = 0; k < n; ++k) {
    const int tid = dense ? k : order[(size_t)g * kMaxS + min(k, kMaxS - 1)];
    const float4* src = reinterpret_cast<const float4*>(
        table + (size_t)tid * kTableRows * kCols);
    for (int i = r; i < kRows * kCols4; i += kRT) tab4[i] = src[i];
    __syncthreads();
    for (int jj = 0; jj < fsub; ++jj) {
      if (fsub > 1 && !dense) {
        const int fid = tid * fsub + jj;
        if (((words[fid >> 5] >> (fid & 31)) & 1u) == 0u) continue;
      }
      for (int i = jj * stf; i < (jj + 1) * stf; i += 4) {
        const int c4 = i / 4;
        const float4 w0 = chain4<0, 6>(tab4, c4, f);
        const float4 w1 = chain4<0, 6>(tab4, kST / 4 + c4, f);
        const float4 w2 = chain4<0, 6>(tab4, 2 * kST / 4 + c4, f);
        const float4 num = chain4<6, 10>(tab4, 3 * kST / 4 + c4, f);
        const float4 den = chain4<0, 3>(tab4, 4 * kST / 4 + c4, f);
        const int id = tid * kST + i;  // ascending: x, y, z, w
        consider(w0.x, w1.x, w2.x, num.x, den.x, id, best_t, best_id);
        consider(w0.y, w1.y, w2.y, num.y, den.y, id + 1, best_t, best_id);
        consider(w0.z, w1.z, w2.z, num.z, den.z, id + 2, best_t, best_id);
        consider(w0.w, w1.w, w2.w, num.w, den.w, id + 3, best_t, best_id);
      }
    }
    __syncthreads();
  }
  t_out[(size_t)g * kRT + r] = best_t;
  id_out[(size_t)g * kRT + r] = best_id;
}

}  // namespace

extern "C" int statmc_twolevel_walk(const float* table, const int* order,
                                    const int* count, const int* mask,
                                    int n_words, const float* feat,
                                    const float* t_max, int n_blocks,
                                    int n_sub, int fsub, float* t_out,
                                    int* id_out, void* stream) {
  if (fsub < 1 || (kST / fsub) % 4 != 0 || kST % fsub != 0 || n_sub < 1)
    return (int)cudaErrorInvalidValue;
  if (n_blocks > 0) {
    twolevel_walk_kernel<<<n_blocks, kRT, 0, (cudaStream_t)stream>>>(
        table, order, count, mask, n_words, feat, t_max, fsub, t_out, id_out);
  }
  return (int)cudaGetLastError();
}
