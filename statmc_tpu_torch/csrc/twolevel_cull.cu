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
// The per-ray test is elementwise (no sum whose order could differ), so
// the votes equal the plain version's bit for bit.  NaN included: the min
// and max propagate a NaN as torch.minimum/maximum do (PTX
// min.NaN/max.NaN), so a ray whose slab times hold a NaN never votes, in
// either version.
//
// What bounds it on the H100: arithmetic, ~20 FP32 operations per (ray,
// box) test.  A camera block votes for a few dozen of the terrain's 4,112
// boxes, so a sweep of every ray against every box spends almost all of
// its tests proving a "no" (3.78e9 tests for 921,600 camera rays).
//
// Design: an exact reject per sub-block before the per-ray sweep.  One
// CUDA block of 256 threads per (512-ray block, share of at most 1,024
// boxes), so that a launch has several blocks per SM to balance.
//  1. The block's live rays (t_max > 0) are ordered in shared memory by
//     the octant of their inverse direction, stably, and each octant's
//     range is cut into sub-blocks of at most kSubRays rays (the plain
//     twin accel/twolevel.py:_sub_blocks makes the same cut).  Dead rays
//     never vote and are dropped; a block with no live ray writes zeros.
//  2. One warp per sub-block reduces the interval of each origin and
//     inverse-direction component and the largest t_max (NaN-propagating).
//  3. A thread per box: for each sub-block the four corner products of
//     fl(fl(lo - o) * inv) and of fl(fl(hi - o) * inv), each rounded on its
//     own (__fsub_rn, __fmul_rn: round-to-nearest is monotone in each
//     argument, so every ray's rounded t0 and t1 lie between the least and
//     the greatest corner), bound every ray's tn from below (tn_lo) and tf
//     from above (tf_up).  The pair is rejected only if the sub-block's
//     intervals are finite and tf_up <= 0 or tn_lo > fl(tf_up * 1.0001);
//     a NaN anywhere propagates and rejects nothing.  A rejected pair has
//     no ray that votes (the CPU tests hold cull_reject to that).
//  4. The surviving (sub-block, box) pairs get the per-ray test, the
//     parent kernel's, with first-vote exit.  Each warp weighs two sweeps
//     of its 32 boxes by its own counts: a thread per box reading the
//     survivors' rays as broadcasts (many survivors: it sweeps at once),
//     or a warp on one box, 32 rays a step with a ballot (few survivors:
//     its boxes go on a list in shared memory that all 8 warps then work
//     through, so that survivors clustered in a few warps' boxes, as the
//     Morton order of boxes makes them, do not leave the others idle).
#include <cuda_runtime.h>
#include <math_constants.h>

#include "plucker.cuh"

namespace {

using plucker::max_nan;
using plucker::min_nan;

constexpr int kRT = 512;       // rays per block (accel/twolevel.py RT_WALK)
constexpr int kThreads = 256;  // threads per CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kSubRays = 128;  // rays per sub-block at most (SUB_RAYS)
constexpr int kMaxSub = 8 + kRT / kSubRays;  // octant ranges, cut
constexpr int kStats = 13;  // o min xyz, o max xyz, inv min, inv max, t_max
constexpr int kBoxesPerCta = 1024;  // boxes of one CUDA block, at most

struct Box {
  float lx, ly, lz, hx, hy, hz;
};

// The parent kernel's per-ray slab test: ray = (ox, oy, oz, ivx),
// (ivy, ivz, t_max, pad).
__device__ __forceinline__ bool slab(const Box& b, float4 a, float4 c) {
  float t0 = __fmul_rn(__fsub_rn(b.lx, a.x), a.w);
  float t1 = __fmul_rn(__fsub_rn(b.hx, a.x), a.w);
  float tn = min_nan(t0, t1);
  float tf = max_nan(t0, t1);
  t0 = __fmul_rn(__fsub_rn(b.ly, a.y), c.x);
  t1 = __fmul_rn(__fsub_rn(b.hy, a.y), c.x);
  tn = max_nan(tn, min_nan(t0, t1));
  tf = min_nan(tf, max_nan(t0, t1));
  t0 = __fmul_rn(__fsub_rn(b.lz, a.z), c.y);
  t1 = __fmul_rn(__fsub_rn(b.hz, a.z), c.y);
  tn = max_nan(tn, min_nan(t0, t1));
  tf = min_nan(tf, max_nan(t0, t1));
  tf = min_nan(tf, c.z);
  return tn <= __fmul_rn(tf, 1.0001f) && tf > 0.0f;
}

// Bounds of one axis' slab times over a sub-block: every ray's min(t0, t1)
// is >= the least corner product and its max(t0, t1) <= the greatest.
__device__ __forceinline__ void axis_bounds(float lo, float hi, float omin,
                                            float omax, float imin,
                                            float imax, float& tn,
                                            float& tf) {
  const float x0 = __fsub_rn(lo, omax), x1 = __fsub_rn(lo, omin);
  const float x2 = __fsub_rn(hi, omax), x3 = __fsub_rn(hi, omin);
  const float p[8] = {__fmul_rn(x0, imin), __fmul_rn(x0, imax),
                      __fmul_rn(x1, imin), __fmul_rn(x1, imax),
                      __fmul_rn(x2, imin), __fmul_rn(x2, imax),
                      __fmul_rn(x3, imin), __fmul_rn(x3, imax)};
  float lower = p[0], upper = p[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    lower = min_nan(lower, p[k]);
    upper = max_nan(upper, p[k]);
  }
  tn = max_nan(tn, lower);
  tf = min_nan(tf, upper);
}

// True when no ray of the sub-block with statistics s can vote for b.
__device__ __forceinline__ bool reject(const Box& b, const float* s) {
  float tn = -1e30f, tf = s[12];
  axis_bounds(b.lx, b.hx, s[0], s[3], s[6], s[9], tn, tf);
  axis_bounds(b.ly, b.hy, s[1], s[4], s[7], s[10], tn, tf);
  axis_bounds(b.lz, b.hz, s[2], s[5], s[8], s[11], tn, tf);
  return tf <= 0.0f || tn > __fmul_rn(tf, 1.0001f);
}

__global__ void __launch_bounds__(kThreads)
twolevel_cull_kernel(const float* __restrict__ bounds,
                     const float* __restrict__ rays, int nf, int per_cta,
                     unsigned char* __restrict__ vote) {
  // Live rays in sub-block order: two float4 each, (ox, oy, oz, ivx),
  // (ivy, ivz, t_max, pad).
  __shared__ float4 ray_s[2 * kRT];
  __shared__ float stat_s[kMaxSub][kStats + 3];
  __shared__ int sub_lo[kMaxSub + 1];  // sub-block s: [sub_lo[s], sub_lo[s+1])
  __shared__ int sub_ok[kMaxSub];      // its intervals are all finite
  __shared__ int base_s[2][kWarps][8];  // per (slot, warp, octant): count,
                                        // then the first destination
  __shared__ int n_sub_s, list_n;
  // The boxes left to the cooperative sweep: local index, sub-blocks.
  __shared__ unsigned short list_j[kBoxesPerCta];
  __shared__ unsigned list_m[kBoxesPerCta];
  __shared__ unsigned char vote_s[kBoxesPerCta];
  const int g = blockIdx.x;
  const int j_lo = blockIdx.y * per_cta, j_hi = min(nf, j_lo + per_cta);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const float4* src =
      reinterpret_cast<const float4*>(rays) + (size_t)g * 2 * kRT;
  unsigned char* out = vote + (size_t)g * nf;

  // 1. Rank each live ray within its octant, in block order.
  float4 ra[2], rc[2];
  int key[2], rank[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = s * kThreads + threadIdx.x;
    ra[s] = src[2 * r];
    rc[s] = src[2 * r + 1];
    key[s] = rc[s].z > 0.0f ? ((ra[s].w > 0.0f) << 2) |
                                  ((rc[s].x > 0.0f) << 1) | (rc[s].y > 0.0f)
                            : 8;
    rank[s] = 0;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const unsigned b = __ballot_sync(0xffffffffu, key[s] == o);
      if (lane == 0) base_s[s][warp][o] = __popc(b);
      if (key[s] == o) rank[s] = __popc(b & below);
    }
  }
  __syncthreads();
  if (warp == 0) {  // lane o < 8: octant o's destinations and sub-blocks
    int n = 0;
    if (lane < 8)
      for (int s = 0; s < 2; ++s)
        for (int w = 0; w < kWarps; ++w) n += base_s[s][w][lane];
    const int pieces = (n + kSubRays - 1) / kSubRays;
    int n_in = n, p_in = pieces;  // inclusive scans over the octants
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, n_in, off);
      const int b = __shfl_up_sync(0xffffffffu, p_in, off);
      if (lane >= off) {
        n_in += a;
        p_in += b;
      }
    }
    if (lane < 8) {
      int acc = n_in - n;
      for (int s = 0; s < 2; ++s)
        for (int w = 0; w < kWarps; ++w) {
          const int c = base_s[s][w][lane];
          base_s[s][w][lane] = acc;
          acc += c;
        }
      for (int k = 0; k < pieces; ++k)
        sub_lo[p_in - pieces + k] = n_in - n + k * kSubRays;
    }
    if (lane == 7) {
      sub_lo[p_in] = n_in;
      n_sub_s = p_in;
      list_n = 0;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 2; ++s)
    if (key[s] < 8) {
      const int d = base_s[s][warp][key[s]] + rank[s];
      ray_s[2 * d] = ra[s];
      ray_s[2 * d + 1] = rc[s];
    }
  __syncthreads();
  const int ns = n_sub_s;
  if (sub_lo[ns] == 0) {  // no live ray: no vote
    for (int j = j_lo + threadIdx.x; j < j_hi; j += kThreads) out[j] = 0;
    return;
  }

  // 2. Per sub-block intervals, one warp each.
  for (int s = warp; s < ns; s += kWarps) {
    float mn[6], mx[6], tm = -CUDART_INF_F;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      mn[q] = CUDART_INF_F;
      mx[q] = -CUDART_INF_F;
    }
    for (int r = sub_lo[s] + lane; r < sub_lo[s + 1]; r += 32) {
      const float4 a = ray_s[2 * r], c = ray_s[2 * r + 1];
      const float v[6] = {a.x, a.y, a.z, a.w, c.x, c.y};
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        mn[q] = min_nan(mn[q], v[q]);
        mx[q] = max_nan(mx[q], v[q]);
      }
      tm = max_nan(tm, c.z);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        mn[q] = min_nan(mn[q], __shfl_xor_sync(0xffffffffu, mn[q], off));
        mx[q] = max_nan(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], off));
      }
      tm = max_nan(tm, __shfl_xor_sync(0xffffffffu, tm, off));
    }
    if (lane == 0) {
      bool finite = true;
#pragma unroll
      for (int q = 0; q < 3; ++q) {  // o min, o max, inv min, inv max
        stat_s[s][q] = mn[q];
        stat_s[s][3 + q] = mx[q];
        stat_s[s][6 + q] = mn[3 + q];
        stat_s[s][9 + q] = mx[3 + q];
      }
#pragma unroll
      for (int q = 0; q < 6; ++q)
        finite = finite && isfinite(mn[q]) && isfinite(mx[q]);
      stat_s[s][12] = tm;
      sub_ok[s] = finite;
    }
  }
  __syncthreads();

  // 3. A box per thread: the reject.  A warp whose 32 boxes keep many
  // (sub-block, box) pairs sweeps them at once, a thread per box; the
  // boxes of the other warps go on the block's list.
  for (int j0 = j_lo + warp * 32; j0 < j_hi; j0 += kThreads) {
    const int j = j0 + lane;
    const bool valid = j < j_hi;
    Box b = {};
    if (valid) {
      // (lx, ly, lz, hx), (hy, hz, pad, pad)
      const float4 q0 = reinterpret_cast<const float4*>(bounds)[2 * j];
      const float4 q1 = reinterpret_cast<const float4*>(bounds)[2 * j + 1];
      b = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y};
    }
    unsigned keep = 0;
    int coop = 0;  // warp steps of the cooperative sweep
    if (valid)
      for (int s = 0; s < ns; ++s)
        if (!sub_ok[s] || !reject(b, stat_s[s])) {
          keep |= 1u << s;
          coop += (sub_lo[s + 1] - sub_lo[s] + 31) >> 5;
        }
    const unsigned any = __reduce_or_sync(0xffffffffu, keep);
    coop = __reduce_add_sync(0xffffffffu, coop);
    int serial = 0;  // ray steps of the thread-per-box sweep
    for (unsigned m = any; m; m &= m - 1) {
      const int s = __ffs(m) - 1;
      serial += sub_lo[s + 1] - sub_lo[s];
    }
    if (serial <= coop) {
      // A thread per box.  The lanes that sweep a sub-block start it
      // together and step through it in lockstep, so every ray is read
      // by all of them at once (a broadcast); a lane leaves at its first
      // vote.  No warp-wide vote inside the loop: the compiler may
      // overlap the tests of consecutive rays.
      bool v = false;
      for (unsigned m = any; m; m &= m - 1) {
        const int s = __ffs(m) - 1;
        if (((keep >> s) & 1u) && !v)
          for (int r = sub_lo[s]; r < sub_lo[s + 1]; ++r)
            if (slab(b, ray_s[2 * r], ray_s[2 * r + 1])) {
              v = true;
              break;
            }
      }
      if (valid) vote_s[j - j_lo] = v;
    } else {
      const unsigned has = __ballot_sync(0xffffffffu, keep != 0);
      int e = 0;
      if (lane == 0) e = atomicAdd(&list_n, __popc(has));
      e = __shfl_sync(0xffffffffu, e, 0) + __popc(has & below);
      if (keep != 0) {
        list_j[e] = (unsigned short)(j - j_lo);
        list_m[e] = keep;
      } else if (valid) {
        vote_s[j - j_lo] = 0;
      }
    }
  }
  __syncthreads();

  // 4. The listed boxes, a warp each in turn: 32 rays a step, ballot.
  const int n_list = list_n;
  for (int e = warp; e < n_list; e += kWarps) {
    const int jl = list_j[e];
    const float4 q0 = reinterpret_cast<const float4*>(bounds)[2 * (j_lo + jl)];
    const float4 q1 =
        reinterpret_cast<const float4*>(bounds)[2 * (j_lo + jl) + 1];
    const Box b = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y};
    bool hit = false;
    for (unsigned m = list_m[e]; m && !hit; m &= m - 1) {
      const int s = __ffs(m) - 1;
      for (int r0 = sub_lo[s]; r0 < sub_lo[s + 1]; r0 += 32) {
        const int r = r0 + lane;
        const bool h =
            r < sub_lo[s + 1] && slab(b, ray_s[2 * r], ray_s[2 * r + 1]);
        if (__any_sync(0xffffffffu, h)) {
          hit = true;
          break;
        }
      }
    }
    if (lane == 0) vote_s[jl] = hit;
  }
  __syncthreads();
  for (int j = j_lo + threadIdx.x; j < j_hi; j += kThreads)
    out[j] = vote_s[j - j_lo];
}

}  // namespace

extern "C" int statmc_twolevel_cull(const float* bounds, const float* rays,
                                    int n_blocks, int nf, unsigned char* vote,
                                    void* stream) {
  if (n_blocks > 0 && nf > 0) {
    // The boxes split evenly over the fewest CUDA blocks of at most
    // kBoxesPerCta each, in whole warps of 32.
    const int n_cta = (nf + kBoxesPerCta - 1) / kBoxesPerCta;
    const int per_cta = ((nf + n_cta - 1) / n_cta + 31) / 32 * 32;
    twolevel_cull_kernel<<<dim3(n_blocks, n_cta), kThreads, 0,
                           (cudaStream_t)stream>>>(bounds, rays, nf, per_cta,
                                                   vote);
  }
  return (int)cudaGetLastError();
}
