// The shared core of kernels B1 (fused_intersect.cu) and B4
// (twolevel_walk.cu): closest hit of a thread's rays over packed
// 128-triangle subtiles that a block streams through shared memory.
//
// A packed subtile is [25, 128] f32 (12.8 KB): only the coefficient rows
// that the table layouts can leave non-zero (accel/plucker.py builds it),
//   rows  0-5   w0 against the ray features f[0:6] = [d, o x d],
//   rows  6-11  w1,   rows 12-17  w2   (the three Plucker edge forms),
//   rows 18-21  num against f[6:10] = [o, 1]   ([-n, n.v0]),
//   rows 22-24  den against the direction      (n),
// one column per triangle.  Per (ray, triangle) pair each form is one
// fused multiply-add chain in row order from +0 (__fmaf_rn), the chain
// the plain versions evaluate (exact float64 products, rounded to float32
// per step);  inside = all w >= 0 or all w <= 0;  t = num / den when
// |den| > 1e-12, else 1e30;  the candidate is t when inside and t > 1e-4,
// else 1e30;  it wins when < best (strict, in ascending id: the smallest
// id wins ties).
//
// What the core does about the card's bound (FP32 instruction slots: an
// SM partition starts one warp instruction per clock, and a pair needs 18
// FMAs before anything can be decided):
//   * register tile: a thread holds NR rays and takes 4 triangles per
//     16-byte shared load (a broadcast: every lane reads the same
//     address), so one load feeds 4 x NR FMAs;
//   * lazy plane forms: num, den and the IEEE division are computed only
//     for pairs that are inside; a pair that is not contributes the
//     candidate 1e30, which can win only while best > 1e30 (a caller's
//     t_max of +inf), so a ray in that state takes the full path too and
//     every result equals the eager evaluation's;
//   * a screen before the exact inside test: q = min(w0 * w1, w0 * w2)
//     is >= 0 for every pair that is inside (equal signs or zeros), so
//     "not (q < 0)" lets every inside pair through (and a NaN, which the
//     exact test then sorts out; besides those only pairs with w0 = 0 or
//     an underflowing product).  It costs 2 multiplies on the FMA pipe
//     and a min and a compare on the half-rate ALU pipe, where the exact
//     test (4 min/max, 2 compares) costs 6 on the ALU pipe.  One
//     predicate is OR-ed over the 4 x NR pairs of a step and branched on
//     once; behind the branch, per ray and then per pair, the exact test
//     decides;
//   * NaN: the exact test's min/max propagate a NaN (PTX min.NaN/max.NaN,
//     the semantics of torch.minimum/maximum), so a NaN w is never
//     inside; a NaN den fails |den| > 1e-12 and a NaN best fails every <:
//     never a hit, as in the plain versions;
//   * dead lanes: a block packs the indices of its live rays, in order,
//     into shared memory (compact_live) and hands them out warp by warp,
//     so dead rays cost whole idle warps, which skip the core, and not
//     idle lanes inside busy ones; the one partly filled warp runs the
//     core instantiated for the number of its slots that hold rays, and
//     its empty lanes repeat the block's last live ray without storing
//     it.  A dead ray (!(t_max > 0)) can never improve, so leaving it out
//     is exact;
//   * a ring of kStages tiles filled with cp.async (16 bytes per thread
//     per request, commit/wait groups; simpler than a bulk copy on an
//     mbarrier and cannot hang on a miscounted barrier, and the 800
//     requests of a tile are ~0.1% of the tile's instructions): the next
//     subtiles load while the current one is computed, one
//     __syncthreads per subtile.
#pragma once
#include <cuda_runtime.h>

namespace plucker {

constexpr int kST = 128;                  // triangles per subtile
constexpr int kPackedRows = 25;           // 6 + 6 + 6 + 4 + 3
constexpr int kRow4 = kST / 4;            // float4 per packed row
constexpr int kTile4 = kPackedRows * kRow4;  // float4 per subtile (800)
constexpr int kStages = 3;                // tiles in the ring (38.4 KB)
constexpr int kRowNum = 18, kRowDen = 22;
constexpr float kMissT = 1e30f;

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

// A thread's rays.  f: the ten features [d, o x d, o, 1]; dd: the
// direction the denominator pairs with (f[0:3] for B4; B1 is handed it
// in its own row).
template <int NR>
struct Rays {
  float f[NR][10];
  float dd[NR][3];
  float best_t[NR];
  int best_id[NR];
};

// The block's live rays, packed.  Thread t says whether ray j * T + t of
// the block is live, for j < NR; on return idx[0 .. n) holds the live
// rays' block-local indices in ascending order and n is returned.  Every
// thread of the block (T threads) must call it.  cnt: NR * T / 32 ints.
template <int NR, int T>
__device__ __forceinline__ int compact_live(const bool (&live)[NR],
                                            unsigned short* idx, int* cnt) {
  constexpr int kWarps = T / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned votes[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    votes[j] = __ballot_sync(0xffffffffu, live[j]);
    if (lane == 0) cnt[j * kWarps + warp] = __popc(votes[j]);
  }
  __syncthreads();
  int first[NR], n = 0;
  for (int c = 0; c < NR * kWarps; ++c) {
#pragma unroll
    for (int j = 0; j < NR; ++j)
      if (c == j * kWarps + warp) first[j] = n;
    n += cnt[c];
  }
#pragma unroll
  for (int j = 0; j < NR; ++j)
    if (live[j])
      idx[first[j] + __popc(votes[j] & ((1u << lane) - 1u))] =
          (unsigned short)(j * T + threadIdx.x);
  __syncthreads();
  return n;
}

// Slot j of this thread takes live ray number warp * 32 * NR + j * 32 +
// lane: a warp's slots fill before the next warp's, so the warps past
// the live count stay empty.
template <int NR>
__device__ __forceinline__ int slot(int j) {
  return (threadIdx.x >> 5) * 32 * NR + j * 32 + (threadIdx.x & 31);
}

// How many of this thread's NR slots the walk computes, given the block's
// n live rays: those up to the warp's last one that holds a ray.
template <int NR>
__device__ __forceinline__ int active_slots(int n) {
  const int mine = n - (threadIdx.x >> 5) * 32 * NR;  // this warp's rays
  return mine <= 0 ? 0 : mine >= 32 * NR ? NR : (mine + 31) / 32;
}

__device__ __forceinline__ float comp(const float4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// The plane forms and the update of one pair (the rare path).
template <int NR>
__device__ __forceinline__ void consider(const float4* __restrict__ tile,
                                         int c4, int c, bool inside, int id,
                                         Rays<NR>& R, int j) {
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    num = __fmaf_rn(comp(tile[(kRowNum + k) * kRow4 + c4], c), R.f[j][6 + k],
                    num);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    den = __fmaf_rn(comp(tile[(kRowDen + k) * kRow4 + c4], c), R.dd[j][k],
                    den);
  const float t = fabsf(den) > 1e-12f ? __fdiv_rn(num, den) : kMissT;
  const float tc = (inside && t > 1e-4f) ? t : kMissT;
  if (tc < R.best_t[j]) {
    R.best_t[j] = tc;
    R.best_id[j] = id;
  }
}

// Triangles 4 * c4 .. 4 * c4 + 3 of a tile against the thread's first NA
// rays; id0 is the packed id of the first.
template <int NR, int NA>
__device__ __forceinline__ void step4(const float4* __restrict__ tile,
                                      int c4, int id0, Rays<NR>& R) {
  float4 w[NA][3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float4 a = tile[(e * 6 + k) * kRow4 + c4];
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const float f = R.f[j][k];
        float4& s = w[j][e];
        s.x = __fmaf_rn(a.x, f, k ? s.x : 0.0f);
        s.y = __fmaf_rn(a.y, f, k ? s.y : 0.0f);
        s.z = __fmaf_rn(a.z, f, k ? s.z : 0.0f);
        s.w = __fmaf_rn(a.w, f, k ? s.w : 0.0f);
      }
    }
  }
  // The screen: q >= 0 (or NaN) for every pair that can be inside.
  float4 q[NA];
  bool any = false;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    q[j].x = min_nan(__fmul_rn(w[j][0].x, w[j][1].x),
                     __fmul_rn(w[j][0].x, w[j][2].x));
    q[j].y = min_nan(__fmul_rn(w[j][0].y, w[j][1].y),
                     __fmul_rn(w[j][0].y, w[j][2].y));
    q[j].z = min_nan(__fmul_rn(w[j][0].z, w[j][1].z),
                     __fmul_rn(w[j][0].z, w[j][2].z));
    q[j].w = min_nan(__fmul_rn(w[j][0].w, w[j][1].w),
                     __fmul_rn(w[j][0].w, w[j][2].w));
    any |= !(q[j].x < 0.0f) || !(q[j].y < 0.0f) || !(q[j].z < 0.0f) ||
           !(q[j].w < 0.0f) || R.best_t[j] > kMissT;
  }
  if (!any) return;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const bool armed = R.best_t[j] > kMissT;
    if (q[j].x < 0.0f && q[j].y < 0.0f && q[j].z < 0.0f && q[j].w < 0.0f &&
        !armed)
      continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float w0 = comp(w[j][0], c), w1 = comp(w[j][1], c),
                  w2 = comp(w[j][2], c);
      const bool inside = min_nan(min_nan(w0, w1), w2) >= 0.0f ||
                          max_nan(max_nan(w0, w1), w2) <= 0.0f;
      if (inside || R.best_t[j] > kMissT)
        consider<NR>(tile, c4, c, inside, id0 + c, R, j);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One ring tile against the thread's first NA rays: the subgroups of stf
// triangles whose bit is set, in ascending order.
template <int NR, int NA>
__device__ __forceinline__ void tile_steps(const float4* __restrict__ tile,
                                           int2 e, int stf, Rays<NR>& R) {
  const int nsg = kST / stf;
  for (int jj = 0; jj < nsg; ++jj) {
    if (((e.y >> jj) & 1) == 0) continue;
#pragma unroll 1
    for (int c4 = jj * stf / 4; c4 < (jj + 1) * stf / 4; ++c4)
      step4<NR, NA>(tile, c4, e.x * kST + c4 * 4, R);
  }
}

// Request subtile `sub` into ring slot `slot` (every thread of the block
// takes its share of the tile's 800 16-byte pieces) when k < n, and close
// the request group either way, so that every thread counts one group
// per k.
__device__ __forceinline__ void request_tile(const float4* __restrict__ packed,
                                             float4* ring, int k, int n,
                                             int sub, int slot) {
  if (k < n) {
    const float4* src = packed + (size_t)sub * kTile4;
    float4* dst = ring + slot * kTile4;
    for (int i = threadIdx.x; i < kTile4; i += blockDim.x)
      cp_async16(dst + i, src + i);
  }
  cp_async_commit();
}

// Start the ring: request the first kStages - 1 subtiles of a walk of n.
// sub_of(k) -> subtile id of entry k.  A kernel calls this as early as it
// knows n and the first ids, so that the tiles travel while it packs its
// rays, and `walk` after it.
template <class SubOf>
__device__ __forceinline__ void start_ring(const float4* __restrict__ packed,
                                           int n, SubOf sub_of,
                                           float4* ring) {
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k)
    request_tile(packed, ring, k, n, k < n ? sub_of(k) : 0, k);
}

// The block walks n subtiles through the ring that `start_ring` started.
// entry(k) -> (subtile id, bits): bit jj set means "test triangles jj *
// stf .. (jj + 1) * stf - 1" (stf a multiple of 4 that divides 128); both
// are uniform over the block.  Every thread of the block must call this
// (it holds the barriers).  n_live: the block's live rays, handed out by
// `slot`; a warp computes only the slots that hold rays (a uniform choice
// per warp, fixed for the walk), and a warp without rays only helps to
// fill the ring.
template <int NR, class Entry>
__device__ __forceinline__ void walk(const float4* __restrict__ packed, int n,
                                     Entry entry, int stf, int n_live,
                                     float4* ring, Rays<NR>& R) {
  static_assert(NR == 4, "the dispatch below lists NA = 1..4");
  const int na = active_slots<NR>(n_live);
  int slot = 0;
  for (int k = 0; k < n; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile k
    __syncthreads();               // everyone's; and tile k - 1 is done with
    const int kn = k + kStages - 1;
    request_tile(packed, ring, kn, n, kn < n ? entry(kn).x : 0,
                 slot == 0 ? kStages - 1 : slot - 1);
    const float4* tile = ring + slot * kTile4;
    switch (na) {
      case 1: tile_steps<NR, 1>(tile, entry(k), stf, R); break;
      case 2: tile_steps<NR, 2>(tile, entry(k), stf, R); break;
      case 3: tile_steps<NR, 3>(tile, entry(k), stf, R); break;
      case 4: tile_steps<NR, 4>(tile, entry(k), stf, R); break;
      default: break;
    }
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// Host side: resident blocks per SM and registers per thread of a
// kernel, as the runtime reports them for this build: out = {blocks,
// registers}.
template <class Kernel>
int occupancy(Kernel kernel, int threads, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return (int)rc;
  out[1] = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                            threads, 0);
}

}  // namespace plucker
