// Kernel B1: closest-hit ray x triangle test over a Morton-ordered
// packed table of at most 16,384 triangles.
//
// Replaces the Pallas TPU kernel statmc_tpu/accel/fused.py:_kernel
// (launched by _intersect_pallas).  Same semantics as the plain version
// accel/fused.py:intersect_plain:
//   packed [2 * n_tiles, 25, 128]  the non-zero coefficient rows of
//                                  edge_table / plane_table, each
//                                  256-triangle tile as two subtiles
//                                  (accel/plucker.py:pack_fused),
//   raye [R, 8] = [d, o x d, 0, 0],  rayp [R, 8] = [d, o, 1, 0],
//   t_max [R]  ->  t [R], id [R] (tile * 256 + k; a miss keeps t_max, -1);
//   n_tris: columns from n_tris on are padding and all zero.
// The per-pair arithmetic is plucker.cuh's, shared with kernel B4; its
// columns are raye[0:6] for the edge forms, rayp[3:7] for the numerator
// and rayp[0:3] for the denominator, the columns the table layout leaves
// non-zero (a zero column only changes the sign of a zero, which no
// comparison reads).
//
// What bounds it on the H100: FP32 instruction slots.  Every live ray meets
// every triangle: 18 FMAs + the inside test per pair, against 12.8 KB of
// table per subtile that all rays of a block share (L2 traffic, far from
// any limit).  The design: kNR rays per thread so that one 16-byte
// shared load feeds 4 x kNR FMAs; the plane forms and the division only
// for pairs inside all three edges; the table streamed through a
// cp.async ring so that no load is exposed; the padding behind the last
// triangle (up to 255 all-zero columns, each of which would count as
// inside for every ray) is not walked; a block packs its live rays into
// as few warps as they need, the other warps only help to fill the
// ring, and a block of dead rays returns at once.  Not here: the TPU
// kernel's per-tile AABB cull and lane compaction across blocks (both
// exact, so results do not depend on them).
#include "plucker.cuh"

namespace {

using namespace plucker;

constexpr int kNR = 4;         // rays per thread
constexpr int kThreads = 128;  // threads per block
constexpr int kBlockRays = kNR * kThreads;
constexpr int kK = 8;          // columns of a ray row

__global__ void __launch_bounds__(kThreads, 4)
fused_intersect_kernel(const float* __restrict__ raye,
                       const float* __restrict__ rayp,
                       const float* __restrict__ t_max,
                       const float4* __restrict__ packed, int n_rays,
                       int n_sub, int n_tris, float* __restrict__ t_out,
                       int* __restrict__ id_out) {
  __shared__ float4 ring[kStages * kTile4];
  __shared__ unsigned short live_idx[kBlockRays];
  __shared__ int live_cnt[kBlockRays / 32];
  const int base = blockIdx.x * kBlockRays;
  // Columns from n_tris on are padding (all zero): every w = 0 counts as
  // inside, den = 0 gives the candidate 1e30.  The walk stops at the last
  // step of 4 that holds a triangle; the padding's only effect, 1e30 for
  // a ray still above it (t_max = +inf), is applied after the walk, where
  // the padding lies in id order.
  const int steps = (n_tris + 3) / 4;
  const int n_walk = (steps + kRow4 - 1) / kRow4;
  start_ring(packed, n_walk, [](int k) { return k; }, ring);
  bool live[kNR];
#pragma unroll
  for (int j = 0; j < kNR; ++j) {
    const int ray = base + j * kThreads + threadIdx.x;
    const float tm = ray < n_rays ? t_max[ray] : 0.0f;
    live[j] = tm > 0.0f;
    if (!live[j] && ray < n_rays) {  // a dead ray keeps t_max
      t_out[ray] = tm;
      id_out[ray] = -1;
    }
  }
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
    ray[j] = base + live_idx[min(s, n_live - 1)];
    if (j >= na) continue;
    const float4* e =
        reinterpret_cast<const float4*>(raye + (size_t)ray[j] * kK);
    const float4* p =
        reinterpret_cast<const float4*>(rayp + (size_t)ray[j] * kK);
    const float4 e0 = e[0], e1 = e[1], p0 = p[0], p1 = p[1];
    R.f[j][0] = e0.x, R.f[j][1] = e0.y, R.f[j][2] = e0.z, R.f[j][3] = e0.w;
    R.f[j][4] = e1.x, R.f[j][5] = e1.y;
    R.f[j][6] = p0.w, R.f[j][7] = p1.x, R.f[j][8] = p1.y, R.f[j][9] = p1.z;
    R.dd[j][0] = p0.x, R.dd[j][1] = p0.y, R.dd[j][2] = p0.z;
    R.best_t[j] = t_max[ray[j]];
    R.best_id[j] = -1;
  }
  auto entry = [&](int k) {
    const int left = steps - k * kRow4;  // steps of subtile k and after
    return make_int2(k, left >= 32 ? -1 : (1 << left) - 1);
  };
  walk<kNR>(packed, n_walk, entry, 4, n_live, ring, R);
#pragma unroll
  for (int j = 0; j < kNR; ++j) {
    if (!keep[j]) continue;
    if (4 * steps < n_sub * kST && R.best_t[j] > kMissT) {
      R.best_t[j] = kMissT;
      R.best_id[j] = 4 * steps;
    }
    t_out[ray[j]] = R.best_t[j];
    id_out[ray[j]] = R.best_id[j];
  }
}

}  // namespace

extern "C" int statmc_fused_intersect(const float* raye, const float* rayp,
                                      const float* t_max, const float* packed,
                                      int n_rays, int n_sub, int n_tris,
                                      float* t_out, int* id_out,
                                      void* stream) {
  if (n_sub < 1 || n_tris < 0 || n_tris > n_sub * kST)
    return (int)cudaErrorInvalidValue;
  if (n_rays > 0) {
    const int blocks = (n_rays + kBlockRays - 1) / kBlockRays;
    fused_intersect_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        raye, rayp, t_max, reinterpret_cast<const float4*>(packed), n_rays,
        n_sub, n_tris, t_out, id_out);
  }
  return (int)cudaGetLastError();
}

// out = {resident blocks per SM, registers per thread} of this build.
extern "C" int statmc_fused_intersect_occupancy(int* out) {
  return occupancy(fused_intersect_kernel, kThreads, out);
}
