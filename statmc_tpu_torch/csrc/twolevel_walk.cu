// Kernel B4: worklist walk of the two-level traversal.
//
// Replaces the Pallas TPU kernel statmc_tpu/accel/twolevel.py:_kernel
// (launched by _walk_pallas).  Same semantics as the plain version
// accel/twolevel.py:walk_plain:
//   packed [nst, 25, 128]  per 128-triangle subtile, the coefficient rows
//                          of table [nst, 16, 640] that its layout can
//                          leave non-zero (accel/plucker.py:pack_subtiles),
//   order [G, 384] int32   block g's worklist in ascending subtile id,
//   count [G] int32        its length; count > 384 means "walk every
//                          subtile densely and ignore the mask",
//   mask  [G, nw] int32    bit f of the block's words: fine subgroup f
//                          (32 triangles when fsub = 4) may be hit,
//   feat  [G, 16, 512]     the block's ray features [d, o x d, o, 1, 0...],
//   t_max [G, 512]  ->  t, id [G, 512]: closest hit; a miss keeps t_max
//                          and id -1.
// The per-pair arithmetic is plucker.cuh's, shared with kernel B1, so the
// two kernels and their plain versions agree bit for bit.
//
// What bounds it on the H100: FP32 instruction slots on the requested (ray,
// triangle) pairs (18 FMAs + the inside test each; how many pairs depends
// on the worklists and submasks, which chip_smoke.py counts for its
// inputs), and, for the short worklists of coherent rays (6 subtiles on
// camera rays), the latency of fetching a subtile.  The design: one CUDA
// block per 512-ray block, 4 rays per thread (a block packs its live
// rays, so a warp holds 128 consecutive live rays and the feature loads
// stay coalesced) and 4 triangles per 16-byte shared load;
// the plane forms and the division only for pairs inside all three edges;
// the worklist and each entry's submask bits are read into shared memory
// once, and the subtiles stream through a cp.async ring, so the next
// entries load while the current one is computed; 128 threads and 40 KB
// of shared memory leave room for four blocks per SM, which covers the
// short blocks' start-up.  The submask bit of a subgroup is the same for
// every thread of the block, so skipping a gated subgroup is a uniform
// branch.  Warps left without live rays only help to fill the ring; a
// block with an empty worklist or no live ray copies t_max and returns.
#include "plucker.cuh"

namespace {

using namespace plucker;

constexpr int kRT = 512;        // rays per block (accel/twolevel.py RT_WALK)
constexpr int kMaxS = 384;      // worklist slots (accel/twolevel.py MAXS)
constexpr int kFeatRows = 16;   // rows of feat
constexpr int kNR = 4;          // rays per thread
constexpr int kThreads = kRT / kNR;

__global__ void __launch_bounds__(kThreads, 4)
twolevel_walk_kernel(const float4* __restrict__ packed,
                     const int* __restrict__ order,
                     const int* __restrict__ count,
                     const int* __restrict__ mask, int n_words,
                     const float* __restrict__ feat,
                     const float* __restrict__ t_max, int fsub,
                     float* __restrict__ t_out, int* __restrict__ id_out) {
  __shared__ float4 ring[kStages * kTile4];
  __shared__ int2 work[kMaxS];  // (subtile id, submask bits) per entry
  __shared__ unsigned short live_idx[kRT];
  __shared__ int live_cnt[kRT / 32];
  const int g = blockIdx.x;
  const int n = count[g];
  const bool dense = n > kMaxS;
  const unsigned all_bits = fsub >= 32 ? 0xffffffffu : (1u << fsub) - 1u;
  // The first subtiles travel while the block reads its worklist and
  // packs its rays.
  start_ring(packed, n,
             [&](int k) { return dense ? k : order[(size_t)g * kMaxS + k]; },
             ring);
  const float* tm_g = t_max + (size_t)g * kRT;
  float* t_g = t_out + (size_t)g * kRT;
  int* id_g = id_out + (size_t)g * kRT;
  bool live[kNR];
#pragma unroll
  for (int j = 0; j < kNR; ++j) {
    const int r = j * kThreads + threadIdx.x;
    const float tm = tm_g[r];
    live[j] = n > 0 && tm > 0.0f;
    if (!live[j]) {  // a dead ray, or an empty worklist: t_max is kept
      t_g[r] = tm;
      id_g[r] = -1;
    }
  }
  if (!dense) {
    // Entry k's subtile and its fsub submask bits (fsub divides 32, so
    // they lie in one word).
    const unsigned* words =
        reinterpret_cast<const unsigned*>(mask) + (size_t)g * n_words;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int tid = order[(size_t)g * kMaxS + k];
      const int fid = tid * fsub;
      work[k] = make_int2(
          tid, fsub > 1 ? (int)((words[fid >> 5] >> (fid & 31)) & all_bits)
                        : 1);
    }
  }
  // Its barriers also publish work[].
  const int n_live = compact_live<kNR, kThreads>(live, live_idx, live_cnt);
  if (n_live == 0) {
    cp_async_wait<0>();
    return;
  }
  // Slot j holds live ray number slot(j); the empty lanes of the warp's
  // last active slot repeat the block's last live ray (keep = false).
  Rays<kNR> R;
  int ray[kNR];
  bool keep[kNR];
  const int na = active_slots<kNR>(n_live);
#pragma unroll
  for (int j = 0; j < kNR; ++j) {
    const int s = slot<kNR>(j);
    keep[j] = s < n_live;
    ray[j] = live_idx[min(s, n_live - 1)];
    if (j >= na) continue;
#pragma unroll
    for (int k = 0; k < 10; ++k)
      R.f[j][k] = feat[((size_t)g * kFeatRows + k) * kRT + ray[j]];
#pragma unroll
    for (int k = 0; k < 3; ++k) R.dd[j][k] = R.f[j][k];
    R.best_t[j] = tm_g[ray[j]];
    R.best_id[j] = -1;
  }
  auto entry = [&](int k) {
    return dense ? make_int2(k, (int)all_bits) : work[k];
  };
  walk<kNR>(packed, n, entry, kST / fsub, n_live, ring,
            R);
#pragma unroll
  for (int j = 0; j < kNR; ++j) {
    if (!keep[j]) continue;
    t_g[ray[j]] = R.best_t[j];
    id_g[ray[j]] = R.best_id[j];
  }
}

}  // namespace

extern "C" int statmc_twolevel_walk(const float* packed, const int* order,
                                    const int* count, const int* mask,
                                    int n_words, const float* feat,
                                    const float* t_max, int n_blocks,
                                    int n_sub, int fsub, float* t_out,
                                    int* id_out, void* stream) {
  if (fsub < 1 || fsub > 32 || kST % fsub != 0 || 32 % fsub != 0 ||
      n_sub < 1)
    return (int)cudaErrorInvalidValue;
  if (n_blocks > 0) {
    twolevel_walk_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(packed), order, count, mask, n_words,
        feat, t_max, fsub, t_out, id_out);
  }
  return (int)cudaGetLastError();
}

// out = {resident blocks per SM, registers per thread} of this build.
extern "C" int statmc_twolevel_walk_occupancy(int* out) {
  return occupancy(twolevel_walk_kernel, kThreads, out);
}
