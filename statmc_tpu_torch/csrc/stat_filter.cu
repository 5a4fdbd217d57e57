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
// What bounds it on the H100: per pixel and offset the test reads 16
// floats of the neighbour (mc, d2, fm at C = 3, six G-buffer planes,
// valid) and spends ~30 FP32 operations plus one expf.  At 1280x720 and
// r = 20 that is 1.55e9 pairs: neighbour loads, served from L1/L2, and
// the expf bound it, not DRAM (each input is 44 MB in all).
//
// Design: one thread per output pixel, 16x16 blocks, neighbours read
// through the read-only cache (__ldg).  The (16+2r)^2 halo of all 16
// planes is 196 KB at r = 20; staging it in shared memory would leave one
// block per SM and a long serial fill, so this first kernel relies on L1:
// a warp reads 32 consecutive pixels of one row per offset, and adjacent
// offsets reuse the same lines.  The window is summed in the same order
// as the plain PyTorch version (denoise/filter_cuda.py), every product
// and sum rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction,
// as in PyTorch's one-op-at-a-time evaluation), with expf (not __expf)
// and no fast-math flags.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 4;   // acceptance channels
constexpr int kMaxCF = 8;  // filtered channels
constexpr int kMaxG = 16;  // G-buffer planes
constexpr int kBlock = 16;

struct Factors {
  float gf[kMaxG];
};

__global__ void __launch_bounds__(kBlock * kBlock)
stat_filter_kernel(const float* __restrict__ mc, const float* __restrict__ d2,
                   const float* __restrict__ fm, const float* __restrict__ gb,
                   const float* __restrict__ valid, int H, int W, int C,
                   int CF, int G, int r, float ds, Factors fac, int normalize,
                   float* __restrict__ out, float* __restrict__ wsum_out) {
  const int x = blockIdx.x * kBlock + threadIdx.x;
  const int y = blockIdx.y * kBlock + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)y * W + x;

  float mc_i[kMaxC], d2_i[kMaxC], g_i[kMaxG], acc[kMaxCF];
  for (int c = 0; c < C; ++c) {
    mc_i[c] = mc[i * C + c];
    d2_i[c] = d2[i * C + c];
  }
  for (int g = 0; g < G; ++g) g_i[g] = gb[i * G + g];
  for (int c = 0; c < CF; ++c) acc[c] = 0.0f;
  float wsum = 0.0f;

  for (int dy = -r; dy <= r; ++dy) {
    const int yj = y + dy;
    if (yj < 0 || yj >= H) continue;
    for (int dx = -r; dx <= r; ++dx) {
      const int xj = x + dx;
      if (xj < 0 || xj >= W) continue;
      const size_t j = (size_t)yj * W + xj;
      bool accept = true;
      for (int c = 0; c < C; ++c) {
        const float diff = __fsub_rn(mc_i[c], __ldg(&mc[j * C + c]));
        const float thr =
            __fadd_rn(__fadd_rn(d2_i[c], __ldg(&d2[j * C + c])), 1e-20f);
        accept = accept && (__fmul_rn(diff, diff) <= thr);
      }
      if (!accept) continue;
      const float fdy = (float)dy, fdx = (float)dx;
      float arg = __fmul_rn(ds, __fadd_rn(fdy * fdy, fdx * fdx));
      for (int g = 0; g < G; ++g) {
        const float dg = __fsub_rn(g_i[g], __ldg(&gb[j * G + g]));
        arg = __fadd_rn(arg, __fmul_rn(fac.gf[g], __fmul_rn(dg, dg)));
      }
      const float w = __fmul_rn(expf(arg), __ldg(&valid[j]));
      wsum = __fadd_rn(wsum, w);
      for (int c = 0; c < CF; ++c)
        acc[c] = __fadd_rn(acc[c], __fmul_rn(w, __ldg(&fm[j * CF + c])));
    }
  }
  const float ws = fmaxf(wsum, 1e-20f);
  for (int c = 0; c < CF; ++c)
    out[i * CF + c] = normalize ? acc[c] / ws : acc[c];
  wsum_out[i] = wsum;
}

}  // namespace

extern "C" int statmc_stat_filter(const float* mc, const float* d2,
                                  const float* fm, const float* gb,
                                  const float* valid, const float* gb_factors,
                                  int H, int W, int C, int CF, int G,
                                  int radius, float ds_factor, int normalize,
                                  float* out, float* wsum, void* stream) {
  if (C > kMaxC || CF > kMaxCF || G > kMaxG) return (int)cudaErrorInvalidValue;
  Factors fac = {};
  for (int g = 0; g < G; ++g) fac.gf[g] = gb_factors[g];
  if (H > 0 && W > 0) {
    const dim3 block(kBlock, kBlock);
    const dim3 grid((W + kBlock - 1) / kBlock, (H + kBlock - 1) / kBlock);
    stat_filter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        mc, d2, fm, gb, valid, H, W, C, CF, G, radius, ds_factor, fac,
        normalize, out, wsum);
  }
  return (int)cudaGetLastError();
}
