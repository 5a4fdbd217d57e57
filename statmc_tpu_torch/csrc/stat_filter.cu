// Statistical joint-bilateral filter (kernel B2), in each of its forms.
//
// Replaces the Pallas TPU kernel statmc_tpu/denoise/filter_pallas.py:
// _filter_kernel (launched by _run_filter) with its three static flags,
// as compile-time template parameters: a range mode {f32, bf16}
// (range_bf16) times an acceptance mode {f32 direct, f32 expanded
// (accept_expand), bf16 direct (accept_bf16, which takes precedence over
// accept_expand)}.  For every pixel i and every neighbour j of the
// (2r+1)^2 window, rows outer and columns inner:
//   f32 direct:   accept = all_c (mc_i - mc_j)^2 <= d2_i + d2_j + 1e-20
//   expanded:     accept = all_c fma(m_i, mc_j, A_j) <= b_i, with
//                 A = fma(mc, mc, -d2), b = fma(-mc, mc, d2 + 1e-20) and
//                 m = -2 mc: the three places where XLA's CPU code
//                 contracts the Pallas kernel's products and sums
//   bf16 direct:  accept = all_c bf(bf(mc_i) - bf(mc_j))^2
//                            <= bf(bf(d2_i + 1e-20) + bf(d2_j)),
//                 every operation rounded to bf16
//   f32 range:    arg = ds (dy^2 + dx^2) + sum_g gf_g (g_i - g_j)^2,
//                 w = expf(arg)
//   bf16 range:   s_g = bf(sqrt(-gf_g) * g) (pre-scaled planes),
//                 arg = bf(ds (dy^2 + dx^2)), then for g = 0..G-1
//                 arg = bf(arg - bf((s_i - s_j)^2)) with d = bf(s_i - s_j),
//                 w = f32(bf(expf(f32(arg))))
// then w *= valid_j, wsum += w, acc[c] += w * fm_j[c] in f32 in every
// form, and out = acc / max(wsum, 1e-20) when normalize, else acc.  With
// G = 0 the range mode changes nothing (the entry point takes the f32
// one).  Neighbours outside the image are the zero padding of the TPU
// kernel (valid = 0; in bf16 range mode its s = 1e19, whose weight
// exponentiates to exactly 0), so they add exactly nothing and are
// skipped.  A rejected neighbour (accept = 0) adds exactly +0 too and
// skips its exponential.
//
// Rounding.  f32 products and sums are rounded one at a time (__fmul_rn /
// __fadd_rn: no FMA contraction, as in PyTorch's one-op-at-a-time
// evaluation) but for the expanded test's three fmaf; expf (not __expf),
// no fast-math flags.  bf16 values are made only by __float2bfloat16_rn
// and read only by __bfloat162float.  The bf16 range term is split: the
// square and the subtraction round separately (square2: __hfma2 with a -0
// addend, which nothing can contract with the __hsub2 after it), as the
// JAX package's interpret-mode run rounds it.  The plain PyTorch version
// (denoise/filter_cuda.py) rounds at the same places, so kernel and plain
// version agree to the last bit but where expf and the library's exp
// differ.
//
// What bounds it on the H100: per (pixel, neighbour) pair the acceptance
// test reads 6 floats of the neighbour (C = 3) and costs 15 FP32
// operations in the f32 direct form, 9 expanded (an FMA and a compare a
// channel), 12 bf16 operations in the bf16 form; an accepted pair adds
// the weight (G = 6 planes: 4 FP32 operations a plane, or 3 bf16 ones in
// bf16 range mode), an expf and the CF sums.  At 1280x720 and r = 20 that
// is 1.5e9 pairs on 44 MB of inputs: the operations bound every form, as
// long as the neighbours come from shared memory and each one read feeds
// several pixels.  The bf16 operations run as bf16x2 instructions on two
// pixels at once: one instruction in an FP32 issue slot does two
// operations, so the bound counts a bf16 operation at twice the FP32 rate
// (133.8 TFLOP/s, the H100 SXM's non-tensor bf16 peak).
//
// Design: a block owns a tile of kTX = 128 columns x P rows, a thread one
// column of P pixels (P = 4 for C = 3, CF = 3, G = 6, the render's shape;
// 2 otherwise), with every pixel's own values and sums in registers; in
// the bf16 modes its centre values are __nv_bfloat162 pairs of pixels
// (0, 1) and (2, 3).  The window rows of the tile are staged one at a
// time, planar (mc, d2, the G-buffer, fm, valid: one plane per channel),
// into a ring of kStages pieces in dynamic shared memory, filled with
// cp.async two pieces ahead; a row wider than kMaxCols columns is staged
// in pieces, left to right.  In bf16 range mode the G-buffer is staged as
// the pre-scaled bf16 planes (written by scale_planes_kernel before the
// sweep), a 4-byte word holding planes (2k, 2k + 1): half the bytes.
// Each staged row serves every pixel of the tile whose window covers it:
// a thread reads a neighbour's 6 test values once (consecutive threads,
// consecutive columns: no bank conflict) and tests them against its P
// pixels, reading the rest only when one of them accepts.  Rows come in
// ascending order and columns ascending within a row, so every pixel
// sums its window in the plain version's order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

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

// Range modes and acceptance modes (the template's kRange, kAccept).
constexpr int kRangeF32 = 0, kRangeBF16 = 1;
constexpr int kAcceptF32 = 0, kAcceptExpand = 1, kAcceptBF16 = 2;

struct Factors {
  float gf[kMaxG];  // -0.5 / sd^2 a plane
  float sc[kMaxG];  // sqrt(-gf) a plane, in double, rounded to float
};

struct Params {
  const float *mc, *d2, *fm, *gb, *valid;
  const __nv_bfloat16* gs;  // bf16 range mode: scaled planes [H, W, 2 GW]
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
// interleaved [H, W, ch] array src of 4-byte words.
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

// The G-buffer words of a pixel: G floats, or in bf16 range mode
// (G + 1) / 2 pairs of bf16 planes.
template <bool kR16>
__device__ __forceinline__ int gwords(int G) {
  return kR16 ? (G + 1) / 2 : G;
}

template <bool kR16>
__device__ __forceinline__ void fill(float* st, const Params& p,
                                     const Piece& pc) {
  const int n = pc.c1 - pc.c0, C = p.C, GW = gwords<kR16>(p.G);
  stage_planes(st, 0, p.cols, p.mc, C, p.W, pc.y, pc.c0, n);
  stage_planes(st, C, p.cols, p.d2, C, p.W, pc.y, pc.c0, n);
  stage_planes(st, 2 * C, p.cols,
               kR16 ? reinterpret_cast<const float*>(p.gs) : p.gb, GW, p.W,
               pc.y, pc.c0, n);
  stage_planes(st, 2 * C + GW, p.cols, p.fm, p.CF, p.W, pc.y, pc.c0, n);
  stage_planes(st, 2 * C + GW + p.CF, p.cols, p.valid, 1, p.W, pc.y, pc.c0,
               n);
}

__device__ __forceinline__ __nv_bfloat162 bf2(float a, float b) {
  return __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

// d * d rounded to bf16 on its own: an FMA with a -0 addend (d * d + -0
// is d * d, +0 included).
__device__ __forceinline__ __nv_bfloat162 square2(__nv_bfloat162 d) {
  const __nv_bfloat16 neg0 = __ushort_as_bfloat16((unsigned short)0x8000U);
  return __hfma2(d, d, __bfloat162bfloat162(neg0));
}

// The bf16 range mode's weight of one pixel from its bf16 argument.
__device__ __forceinline__ float weight16(__nv_bfloat16 arg) {
  return __bfloat162float(__float2bfloat16_rn(expf(__bfloat162float(arg))));
}

// s_g = bf16(sqrt(-gf_g) * g) for the n pixels' G planes, into [n, Gp]
// (Gp = G rounded up to even; the pad plane is 0 and adds exactly 0).
__global__ void scale_planes_kernel(const float* gb, __nv_bfloat16* gs,
                                    int n, int G, int Gp, Factors fac) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * Gp) return;
  const int pix = i / Gp, g = i % Gp;
  gs[i] = __float2bfloat16_rn(
      g < G ? __fmul_rn(gb[(size_t)pix * G + g], fac.sc[g]) : 0.0f);
}

// kExact: the channel counts are kC, kCF, kG; else at most those.
template <int kC, int kCF, int kG, int kP, bool kExact, int kRange,
          int kAccept>
__global__ void __launch_bounds__(kTX)
stat_filter_kernel(Params p, Factors fac) {
  static_assert(kP % 2 == 0, "pixels pair up in the bf16 modes");
  constexpr bool kR16 = kRange == kRangeBF16;
  constexpr bool kA16 = kAccept == kAcceptBF16;
  constexpr bool kAX = kAccept == kAcceptExpand;
  constexpr int kQ = kP / 2;  // pixel pairs
  extern __shared__ float smem[];
  const int C = kExact ? kC : p.C;
  const int CF = kExact ? kCF : p.CF;
  const int G = kExact ? kG : p.G;
  const int GW = gwords<kR16>(G);
  const int H = p.H, W = p.W, r = p.r;
  const int tx0 = blockIdx.x * kTX, ty0 = blockIdx.y * kP;
  const int x = tx0 + threadIdx.x;

  // Stages: the window rows of the tile inside the image, each in npc
  // pieces of at most p.cols columns.
  const int y_lo = max(0, ty0 - r), y_hi = min(H - 1, ty0 + kP - 1 + r);
  const int xs0 = max(0, tx0 - r), xs1 = min(W, tx0 + kTX + r);
  const int npc = (xs1 - xs0 + p.cols - 1) / p.cols;
  const int n_stages = (y_hi - y_lo + 1) * npc;
  const int stage_floats = (2 * C + GW + CF + 1) * p.cols;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_stages)
      fill<kR16>(smem + t * stage_floats, p,
                 piece(p, t, y_lo, xs0, xs1, npc));
    cp_async_commit();
  }

  // The pixels' own values.  mc_i / d2_i: mc and d2 for the f32 direct
  // test, -2 mc and b for the expanded one.  mc16 / thr16: bf16(mc) and
  // bf16(d2 + 1e-20) of pixel pairs.  g_i: the f32 G-buffer; s_i: the
  // bf16 scaled planes of pixel pairs.
  float mc_i[kP][kC], d2_i[kP][kC], acc[kP][kCF], wsum[kP];
  float g_i[kP][kR16 ? 1 : kG];
  __nv_bfloat162 mc16[kQ][kA16 ? kC : 1], thr16[kQ][kA16 ? kC : 1];
  __nv_bfloat162 s_i[kQ][kR16 ? kG : 1];
  size_t idx[kP];
#pragma unroll
  for (int pp = 0; pp < kP; ++pp) {
    const int y = ty0 + pp;
    const size_t i = (x < W && y < H) ? (size_t)y * W + x : 0;
    idx[pp] = i;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float m = c < C ? p.mc[i * C + c] : 0.0f;
      const float d = c < C ? p.d2[i * C + c] : 0.0f;
      if constexpr (kAX) {
        mc_i[pp][c] = __fmul_rn(-2.0f, m);
        d2_i[pp][c] = fmaf(-m, m, __fadd_rn(d, 1e-20f));
      } else {
        mc_i[pp][c] = m;
        d2_i[pp][c] = d;
      }
    }
    if constexpr (!kR16) {
#pragma unroll
      for (int g = 0; g < kG; ++g)
        g_i[pp][g] = g < G ? p.gb[i * G + g] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kCF; ++c) acc[pp][c] = 0.0f;
    wsum[pp] = 0.0f;
  }
  if constexpr (kA16) {
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        mc16[q][c] = bf2(mc_i[2 * q][c], mc_i[2 * q + 1][c]);
        thr16[q][c] = bf2(__fadd_rn(d2_i[2 * q][c], 1e-20f),
                          __fadd_rn(d2_i[2 * q + 1][c], 1e-20f));
      }
  }
  if constexpr (kR16) {
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (g < G)
          s_i[q][g] = __halves2bfloat162(p.gs[idx[2 * q] * 2 * GW + g],
                                         p.gs[idx[2 * q + 1] * 2 * GW + g]);
  }

  for (int t = 0; t < n_stages; ++t) {
    const int tn = t + kStages - 1;
    if (tn < n_stages)
      fill<kR16>(smem + (tn % kStages) * stage_floats, p,
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
      if constexpr (kA16) {
        __nv_bfloat162 mj2[kC], dj2[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c)
          if (c < C) {
            mj2[c] = __bfloat162bfloat162(__float2bfloat16_rn(mj[c]));
            dj2[c] = __bfloat162bfloat162(__float2bfloat16_rn(dj[c]));
          }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          bool a0 = act[2 * q], a1 = act[2 * q + 1];
#pragma unroll
          for (int c = 0; c < kC; ++c)
            if (c < C) {
              const __nv_bfloat162 d = __hsub2(mc16[q][c], mj2[c]);
              const __nv_bfloat162 le =
                  __hle2(square2(d), __hadd2(thr16[q][c], dj2[c]));
              a0 = a0 & (__bfloat162float(__low2bfloat16(le)) != 0.0f);
              a1 = a1 & (__bfloat162float(__high2bfloat16(le)) != 0.0f);
            }
          ok[2 * q] = a0;
          ok[2 * q + 1] = a1;
          any = any | a0 | a1;
        }
      } else {
        float an[kC];  // expanded: A_j = mc_j^2 - d2_j, one rounding
        if constexpr (kAX) {
#pragma unroll
          for (int c = 0; c < kC; ++c)
            if (c < C) an[c] = fmaf(mj[c], mj[c], -dj[c]);
        }
#pragma unroll
        for (int pp = 0; pp < kP; ++pp) {
          bool a = act[pp];
#pragma unroll
          for (int c = 0; c < kC; ++c)
            if (c < C) {
              if constexpr (kAX) {
                a = a & (fmaf(mc_i[pp][c], mj[c], an[c]) <= d2_i[pp][c]);
              } else {
                const float diff = __fsub_rn(mc_i[pp][c], mj[c]);
                const float thr =
                    __fadd_rn(__fadd_rn(d2_i[pp][c], dj[c]), 1e-20f);
                a = a & (__fmul_rn(diff, diff) <= thr);
              }
            }
          ok[pp] = a;
          any = any | a;
        }
      }
      if (!any) continue;
      float fj[kCF];
#pragma unroll
      for (int c = 0; c < kCF; ++c)
        if (c < CF) fj[c] = st[(2 * C + GW + c) * p.cols + col];
      const float vj = st[(2 * C + GW + CF) * p.cols + col];
      const float fdx2 = (float)dx * (float)dx;
      float w[kP];
      if constexpr (kR16) {
        // The neighbour's planes, each broadcast to both halves.
        const __nv_bfloat162* sw =
            reinterpret_cast<const __nv_bfloat162*>(st + 2 * C * p.cols);
        __nv_bfloat162 sj[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < G) {
            const __nv_bfloat162 word = sw[(g / 2) * p.cols + col];
            sj[g] = __bfloat162bfloat162(g % 2 ? __high2bfloat16(word)
                                               : __low2bfloat16(word));
          }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          if (!(ok[2 * q] | ok[2 * q + 1])) continue;
          __nv_bfloat162 arg =
              bf2(__fmul_rn(p.ds, __fadd_rn(fdy2[2 * q], fdx2)),
                  __fmul_rn(p.ds, __fadd_rn(fdy2[2 * q + 1], fdx2)));
#pragma unroll
          for (int g = 0; g < kG; ++g)
            if (g < G) {
              const __nv_bfloat162 d = __hsub2(s_i[q][g], sj[g]);
              arg = __hsub2(arg, square2(d));
            }
          w[2 * q] = weight16(__low2bfloat16(arg));
          w[2 * q + 1] = weight16(__high2bfloat16(arg));
        }
      } else {
        float gj[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < G) gj[g] = st[(2 * C + g) * p.cols + col];
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
          w[pp] = expf(arg);
        }
      }
#pragma unroll
      for (int pp = 0; pp < kP; ++pp) {
        if (!ok[pp]) continue;
        const float wv = __fmul_rn(w[pp], vj);
        wsum[pp] = __fadd_rn(wsum[pp], wv);
#pragma unroll
        for (int c = 0; c < kCF; ++c)
          if (c < CF) acc[pp][c] = __fadd_rn(acc[pp][c], __fmul_rn(wv, fj[c]));
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

template <int kC, int kCF, int kG, int kP, bool kExact, int kRange,
          int kAccept>
void launch(const Params& p, const Factors& fac, size_t smem,
            cudaStream_t stream) {
  auto kernel = stat_filter_kernel<kC, kCF, kG, kP, kExact, kRange, kAccept>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid((p.W + kTX - 1) / kTX, (p.H + kP - 1) / kP);
  kernel<<<grid, kTX, smem, stream>>>(p, fac);
}

// The six forms of one channel shape.
template <int kC, int kCF, int kG, int kP, bool kExact>
void launch_form(int range16, int accept, const Params& p,
                 const Factors& fac, size_t smem, cudaStream_t stream) {
  if (range16) {
    if (accept == kAcceptBF16)
      launch<kC, kCF, kG, kP, kExact, kRangeBF16, kAcceptBF16>(p, fac, smem,
                                                               stream);
    else if (accept == kAcceptExpand)
      launch<kC, kCF, kG, kP, kExact, kRangeBF16, kAcceptExpand>(
          p, fac, smem, stream);
    else
      launch<kC, kCF, kG, kP, kExact, kRangeBF16, kAcceptF32>(p, fac, smem,
                                                              stream);
  } else {
    if (accept == kAcceptBF16)
      launch<kC, kCF, kG, kP, kExact, kRangeF32, kAcceptBF16>(p, fac, smem,
                                                              stream);
    else if (accept == kAcceptExpand)
      launch<kC, kCF, kG, kP, kExact, kRangeF32, kAcceptExpand>(p, fac, smem,
                                                                stream);
    else
      launch<kC, kCF, kG, kP, kExact, kRangeF32, kAcceptF32>(p, fac, smem,
                                                             stream);
  }
}

}  // namespace

// _run_filter's arguments and flags: accept_expand, range_bf16 and
// accept_bf16 (0 or 1; accept_bf16 takes precedence over accept_expand,
// and range_bf16 acts only with G > 0).  gb_factors: gf a plane, in
// double as the caller holds it: the f32 range mode uses it rounded to
// float, the bf16 one the scale (float)sqrt(-gf) of the double (the JAX
// package's Python-float scale, rounded where it meets a float32 plane).
// gs: scratch of H * W * (G rounded up to even) bf16 values, which the
// bf16 range mode fills with the scaled planes (unused otherwise).
extern "C" int statmc_stat_filter(const float* mc, const float* d2,
                                  const float* fm, const float* gb,
                                  const float* valid,
                                  const double* gb_factors, int H, int W,
                                  int C, int CF, int G, int radius,
                                  float ds_factor,
                                  int normalize, int accept_expand,
                                  int range_bf16, int accept_bf16, void* gs,
                                  float* out, float* wsum, void* stream) {
  const bool range16 = range_bf16 && G > 0;
  if (C < 1 || C > kMaxC || CF < 1 || CF > kMaxCF || G < 0 || G > kMaxG ||
      radius < 0 || (range16 && gs == nullptr))
    return (int)cudaErrorInvalidValue;
  const int accept = accept_bf16 ? kAcceptBF16
                     : accept_expand ? kAcceptExpand
                                     : kAcceptF32;
  Factors fac = {};
  for (int g = 0; g < G; ++g) {
    fac.gf[g] = (float)gb_factors[g];
    fac.sc[g] = (float)std::sqrt(-gb_factors[g]);
  }
  if (H > 0 && W > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int Gp = G + (G & 1);
    if (range16) {
      const int n = H * W * Gp;
      scale_planes_kernel<<<(n + 255) / 256, 256, 0, st>>>(
          gb, (__nv_bfloat16*)gs, H * W, G, Gp, fac);
    }
    // Offsets past the image never land inside it.
    const int r = std::min(radius, H + W);
    const int cols = std::min(kMaxCols, std::min(W, kTX + 2 * r));
    const Params p = {mc,        d2,        fm, gb,        valid,
                      (const __nv_bfloat16*)gs,
                      H,         W,         C,  CF,        G,
                      r,         ds_factor, normalize, out, wsum,
                      cols};
    const int gw = range16 ? Gp / 2 : G;
    const size_t smem =
        (size_t)kStages * (2 * C + gw + CF + 1) * cols * sizeof(float);
    if (C == 3 && CF == 3 && G == 6)
      launch_form<3, 3, 6, 4, true>(range16, accept, p, fac, smem, st);
    else
      launch_form<kMaxC, kMaxCF, kMaxG, 2, false>(range16, accept, p, fac,
                                                  smem, st);
  }
  return (int)cudaGetLastError();
}
