// Statistical joint-bilateral filter, f32 direct form.
//
// Replaces the Pallas TPU kernel statmc_tpu/denoise/filter_pallas.py:
// _filter_kernel (launched by _run_filter) in its f32 direct form
// (accept_expand=False, range_bf16=False).  For every pixel i and every
// neighbour j of the (2r+1)^2 window, rows outer and columns inner:
//   accept = for all c: (mc_i[c] - mc_j[c])^2 <= d2_i[c] + d2_j[c] + 1e-20
//   arg    = ds * (dy^2 + dx^2);  arg += gf[g] * (g_i[g] - g_j[g])^2, g = 0..G-1
//   w      = expf(arg) * accept * valid_j
//   wsum  += w;  acc[c] += w * fm_j[c]
// out = acc / max(wsum, 1e-20) when normalize, else acc.  Neighbours
// outside the image are the zero padding of the TPU kernel (valid = 0),
// so they add exactly nothing and are skipped.  A rejected neighbour
// (accept = 0) adds exactly +0 too and skips its exponential.
//
// What bounds it on the H100: per (pixel, neighbour) pair the acceptance
// test is ~15 FP32 operations on 6 floats of the neighbour (C = 3); an
// accepted pair adds the weight (G = 6 planes), an expf and the CF sums.
// At 1280x720 and r = 20 that is 1.5e9 pairs on 44 MB of inputs: the
// operations bound it, as long as the neighbours come from shared memory
// and each one read feeds several pixels.
//
// Design: a block owns a tile of kTX = 128 columns x P rows, a thread one
// column of P pixels (P = 4 for C = 3, CF = 3, G = 6, the render's shape;
// 2 otherwise), with every pixel's own values and sums in registers.  The
// window rows of the tile are staged one at a time, planar (mc, d2, gb,
// fm, valid: one plane per channel), into a ring of kStages pieces in
// dynamic shared memory, filled with cp.async two pieces ahead; a row
// wider than kMaxCols columns is staged in pieces, left to right.  Each
// staged row serves every pixel of the tile whose window covers it: a
// thread reads a neighbour's 6 test values once (consecutive threads,
// consecutive columns: no bank conflict) and tests them against its P
// pixels, reading the other 10 only when one of them accepts.  Rows come
// in ascending order and columns ascending within a row, so every pixel
// sums its window in the plain PyTorch version's order
// (denoise/filter_cuda.py), every product and sum rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction, as in PyTorch's
// one-op-at-a-time evaluation), with expf (not __expf) and no fast-math
// flags.
#include <cuda_runtime.h>

#include <algorithm>

#include "plucker.cuh"  // cp_async_commit, cp_async_wait

namespace {

using plucker::cp_async_commit;
using plucker::cp_async_wait;

constexpr int kMaxC = 4;   // acceptance channels
constexpr int kMaxCF = 8;  // filtered channels
constexpr int kMaxG = 16;  // G-buffer planes
constexpr int kTX = 128;   // tile columns = threads per block
constexpr int kStages = 3;
constexpr int kMaxCols = 256;  // columns of one staged piece, at most

struct Factors {
  float gf[kMaxG];
};

struct Params {
  const float *mc, *d2, *fm, *gb, *valid;
  int H, W, C, CF, G, r;
  float ds;
  int normalize;
  float *out, *wsum;
  int cols;  // columns of a staged piece (its plane stride)
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Planes [q, q + ch) of a piece: columns [c0, c0 + n) of row y of the
// interleaved [H, W, ch] array src.
__device__ __forceinline__ void stage_planes(float* st, int q, int cols,
                                             const float* src, int ch,
                                             int W, int y, int c0, int n) {
  for (int col = threadIdx.x; col < n; col += kTX) {
    const float* s = src + ((size_t)y * W + c0 + col) * ch;
    for (int c = 0; c < ch; ++c) cp_async4(st + (q + c) * cols + col, s + c);
  }
}

// Stage t of a tile: row y_lo + t / npc, columns [c0, c1) of piece t % npc.
struct Piece {
  int y, c0, c1;
};

__device__ __forceinline__ Piece piece(const Params& p, int t, int y_lo,
                                       int xs0, int xs1, int npc) {
  const int c0 = xs0 + (t % npc) * p.cols;
  return {y_lo + t / npc, c0, min(xs1, c0 + p.cols)};
}

__device__ __forceinline__ void fill(float* st, const Params& p,
                                     const Piece& pc) {
  const int n = pc.c1 - pc.c0, C = p.C, G = p.G;
  stage_planes(st, 0, p.cols, p.mc, C, p.W, pc.y, pc.c0, n);
  stage_planes(st, C, p.cols, p.d2, C, p.W, pc.y, pc.c0, n);
  stage_planes(st, 2 * C, p.cols, p.gb, G, p.W, pc.y, pc.c0, n);
  stage_planes(st, 2 * C + G, p.cols, p.fm, p.CF, p.W, pc.y, pc.c0, n);
  stage_planes(st, 2 * C + G + p.CF, p.cols, p.valid, 1, p.W, pc.y, pc.c0, n);
}

// kExact: the channel counts are kC, kCF, kG; else at most those.
template <int kC, int kCF, int kG, int kP, bool kExact>
__global__ void __launch_bounds__(kTX)
stat_filter_kernel(Params p, Factors fac) {
  extern __shared__ float smem[];
  const int C = kExact ? kC : p.C;
  const int CF = kExact ? kCF : p.CF;
  const int G = kExact ? kG : p.G;
  const int H = p.H, W = p.W, r = p.r;
  const int tx0 = blockIdx.x * kTX, ty0 = blockIdx.y * kP;
  const int x = tx0 + threadIdx.x;

  // Stages: the window rows of the tile inside the image, each in npc
  // pieces of at most p.cols columns.
  const int y_lo = max(0, ty0 - r), y_hi = min(H - 1, ty0 + kP - 1 + r);
  const int xs0 = max(0, tx0 - r), xs1 = min(W, tx0 + kTX + r);
  const int npc = (xs1 - xs0 + p.cols - 1) / p.cols;
  const int n_stages = (y_hi - y_lo + 1) * npc;
  const int stage_floats = (2 * C + G + CF + 1) * p.cols;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_stages)
      fill(smem + t * stage_floats, p, piece(p, t, y_lo, xs0, xs1, npc));
    cp_async_commit();
  }

  float mc_i[kP][kC], d2_i[kP][kC], g_i[kP][kG], acc[kP][kCF], wsum[kP];
#pragma unroll
  for (int pp = 0; pp < kP; ++pp) {
    const int y = ty0 + pp;
    const size_t i = (x < W && y < H) ? (size_t)y * W + x : 0;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      mc_i[pp][c] = c < C ? p.mc[i * C + c] : 0.0f;
      d2_i[pp][c] = c < C ? p.d2[i * C + c] : 0.0f;
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) g_i[pp][g] = g < G ? p.gb[i * G + g] : 0.0f;
#pragma unroll
    for (int c = 0; c < kCF; ++c) acc[pp][c] = 0.0f;
    wsum[pp] = 0.0f;
  }

  for (int t = 0; t < n_stages; ++t) {
    const int tn = t + kStages - 1;
    if (tn < n_stages)
      fill(smem + (tn % kStages) * stage_floats, p,
           piece(p, tn, y_lo, xs0, xs1, npc));
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const Piece pc = piece(p, t, y_lo, xs0, xs1, npc);
    const float* st = smem + (t % kStages) * stage_floats;
    bool act[kP], any_act = false;
    float fdy2[kP];
#pragma unroll
    for (int pp = 0; pp < kP; ++pp) {
      const int dy = pc.y - (ty0 + pp);
      act[pp] = x < W && ty0 + pp < H && dy >= -r && dy <= r;
      any_act = any_act || act[pp];
      fdy2[pp] = (float)dy * (float)dy;
    }
    const int dlo = max(-r, pc.c0 - x), dhi = min(r, pc.c1 - 1 - x);
    for (int dx = any_act ? dlo : dhi + 1; dx <= dhi; ++dx) {
      const int col = x + dx - pc.c0;
      float mj[kC], dj[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (c < C) {
          mj[c] = st[c * p.cols + col];
          dj[c] = st[(C + c) * p.cols + col];
        }
      bool ok[kP], any = false;
#pragma unroll
      for (int pp = 0; pp < kP; ++pp) {
        bool a = act[pp];
#pragma unroll
        for (int c = 0; c < kC; ++c)
          if (c < C) {
            const float diff = __fsub_rn(mc_i[pp][c], mj[c]);
            const float thr =
                __fadd_rn(__fadd_rn(d2_i[pp][c], dj[c]), 1e-20f);
            a = a & (__fmul_rn(diff, diff) <= thr);
          }
        ok[pp] = a;
        any = any | a;
      }
      if (!any) continue;
      float gj[kG], fj[kCF];
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (g < G) gj[g] = st[(2 * C + g) * p.cols + col];
#pragma unroll
      for (int c = 0; c < kCF; ++c)
        if (c < CF) fj[c] = st[(2 * C + G + c) * p.cols + col];
      const float vj = st[(2 * C + G + CF) * p.cols + col];
      const float fdx2 = (float)dx * (float)dx;
#pragma unroll
      for (int pp = 0; pp < kP; ++pp) {
        if (!ok[pp]) continue;
        float arg = __fmul_rn(p.ds, __fadd_rn(fdy2[pp], fdx2));
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < G) {
            const float dg = __fsub_rn(g_i[pp][g], gj[g]);
            arg = __fadd_rn(arg, __fmul_rn(fac.gf[g], __fmul_rn(dg, dg)));
          }
        const float w = __fmul_rn(expf(arg), vj);
        wsum[pp] = __fadd_rn(wsum[pp], w);
#pragma unroll
        for (int c = 0; c < kCF; ++c)
          if (c < CF) acc[pp][c] = __fadd_rn(acc[pp][c], __fmul_rn(w, fj[c]));
      }
    }
    __syncthreads();  // the next fill reuses this slot
  }

#pragma unroll
  for (int pp = 0; pp < kP; ++pp) {
    const int y = ty0 + pp;
    if (x >= W || y >= H) continue;
    const size_t i = (size_t)y * W + x;
    const float ws = fmaxf(wsum[pp], 1e-20f);
#pragma unroll
    for (int c = 0; c < kCF; ++c)
      if (c < CF) p.out[i * CF + c] = p.normalize ? acc[pp][c] / ws : acc[pp][c];
    p.wsum[i] = wsum[pp];
  }
}

template <int kC, int kCF, int kG, int kP, bool kExact>
void launch(const Params& p, const Factors& fac, size_t smem,
            cudaStream_t stream) {
  auto kernel = stat_filter_kernel<kC, kCF, kG, kP, kExact>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid((p.W + kTX - 1) / kTX, (p.H + kP - 1) / kP);
  kernel<<<grid, kTX, smem, stream>>>(p, fac);
}

}  // namespace

extern "C" int statmc_stat_filter(const float* mc, const float* d2,
                                  const float* fm, const float* gb,
                                  const float* valid, const float* gb_factors,
                                  int H, int W, int C, int CF, int G,
                                  int radius, float ds_factor, int normalize,
                                  float* out, float* wsum, void* stream) {
  if (C < 1 || C > kMaxC || CF < 1 || CF > kMaxCF || G < 0 || G > kMaxG ||
      radius < 0)
    return (int)cudaErrorInvalidValue;
  Factors fac = {};
  for (int g = 0; g < G; ++g) fac.gf[g] = gb_factors[g];
  if (H > 0 && W > 0) {
    // Offsets past the image never land inside it.
    const int r = std::min(radius, H + W);
    const int cols = std::min(kMaxCols, std::min(W, kTX + 2 * r));
    const Params p = {mc, d2, fm,        gb,        valid, H,    W,   C,
                      CF, G,  r,         ds_factor, normalize, out, wsum,
                      cols};
    const size_t smem = (size_t)kStages * (2 * C + G + CF + 1) * cols *
                        sizeof(float);
    if (C == 3 && CF == 3 && G == 6)
      launch<3, 3, 6, 4, true>(p, fac, smem, (cudaStream_t)stream);
    else
      launch<kMaxC, kMaxCF, kMaxG, 2, false>(p, fac, smem,
                                             (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
