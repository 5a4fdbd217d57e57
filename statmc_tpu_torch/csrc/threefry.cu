// Kernel R1: a threefry draw site of the integrator's random streams in one
// launch.
//
// Replaces no pallas_call of the JAX package: there XLA fuses each draw
// site of statmc_tpu/core/rng.py (fold_in twice, then uniform) into one
// computation, while the port's plain version, core/rng.py:site_hash_plain,
// emulates uint32 arithmetic with int64 tensors, ~171 eager operations a
// Threefry-2x32 and ~530 launches a random-mode draw site.  Same semantics
// as that plain version, bit for bit:
//   key   [N, 2] int64 pairs holding uint32 words; lane l reads pair
//         (l / key_div) % key_mod (a broadcast key reads one pair);
//   words up to two fold words, each one value for every lane or an
//         int32/int64 tensor read at (l / div) % mod, taken mod 2^32;
//         each is folded in as jax.random.fold_in does:
//         key = threefry2x32(key, (0, word));
//   then either the folded key is written as an int64 pair (n_ctr 0), or
//   counters c = 0 .. n_ctr - 1 are hashed under it, (a, b) =
//   threefry2x32(key, (0, c)), and out[l, c] = float32 with the bits
//   ((a ^ b) >> 9) | 0x3F800000, less 1 (jax.random.uniform).
// Integer arithmetic and one exact float subtraction: nothing to round.
//
// What bounds it on the H100: integer operations.  A Threefry-2x32 of 20
// rounds is ~80 of them (per round an add, a rotate and an xor; five key
// injections), and a 2D draw site hashes four times a lane (two folds, two
// counters), ~320 a lane, against 16 + 4-8 bytes read and 8-16 written.
//
// Design: one thread a lane and up to kPer counters (a draw site's one or
// two counters in one thread, which folds its key once); a key with many
// counters (jax.random.uniform of a shape) spreads them over threads in
// chunks of kPer.  Broadcast operands are indexed, never expanded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kPer = 4;  // counters a thread, at most

// Mirrors core/rng.py:_R1Word.
struct Word {
  const void* ptr;  // int32 or int64 words, or null: `value` for each lane
  long long div, mod;
  int is64;
  unsigned value;
};

// Mirrors core/rng.py:_R1Args.
struct Args {
  const long long* key;
  long long key_div, key_mod;
  Word w[2];
  int n_words;
  long long n_lanes, n_ctr;
  long long* key_out;  // [n_lanes, 2] when n_ctr is 0
  float* u_out;        // [n_lanes, n_ctr] otherwise
};

__device__ __forceinline__ long long row(long long l, long long div,
                                         long long mod) {
  if (mod == 1) return 0;
  const long long q = div == 1 ? l : l / div;
  return q < mod ? q : q % mod;
}

__device__ __forceinline__ uint32_t word(const Word& w, long long l) {
  if (w.ptr == nullptr) return w.value;
  const long long i = row(l, w.div, w.mod);
  return w.is64 ? (uint32_t) static_cast<const long long*>(w.ptr)[i]
                : (uint32_t) static_cast<const int*>(w.ptr)[i];
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds (jax/_src/prng.py:_threefry2x32_lowering).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = x0 + ks[0], b = x1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl(b, rot[i % 2][j]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(a, b);
}

__global__ void __launch_bounds__(kThreads) threefry_kernel(const Args p,
                                                            long long chunks) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= p.n_lanes * chunks) return;
  const long long l = t / chunks;
  const long long ki = row(l, p.key_div, p.key_mod);
  uint32_t k0 = (uint32_t)p.key[2 * ki], k1 = (uint32_t)p.key[2 * ki + 1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i < p.n_words) {
      const uint2 r = threefry2x32(k0, k1, 0u, word(p.w[i], l));
      k0 = r.x;
      k1 = r.y;
    }
  }
  if (p.n_ctr == 0) {
    p.key_out[2 * l] = k0;
    p.key_out[2 * l + 1] = k1;
    return;
  }
  const long long c0 = (t - l * chunks) * kPer;
  const long long c1 = c0 + kPer < p.n_ctr ? c0 + kPer : p.n_ctr;
  for (long long c = c0; c < c1; ++c) {
    const uint2 r = threefry2x32(k0, k1, 0u, (uint32_t)c);
    p.u_out[l * p.n_ctr + c] =
        __uint_as_float(((r.x ^ r.y) >> 9) | 0x3F800000u) - 1.0f;
  }
}

}  // namespace

// args: a struct Args (a void pointer: a type of the unnamed namespace in
// the signature would give the entry point internal linkage).
extern "C" int statmc_threefry(const void* args, void* stream) {
  const Args p = *static_cast<const Args*>(args);
  const long long chunks = p.n_ctr == 0 ? 1 : (p.n_ctr + kPer - 1) / kPer;
  const long long threads = p.n_lanes * chunks;
  if (threads > 0) {
    const long long blocks = (threads + kThreads - 1) / kThreads;
    threefry_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        p, chunks);
  }
  return (int)cudaGetLastError();
}
