// K7: uniform [0, 1) float32 draws (and their raw 32-bit words) of the
// threefry-2x32-20 key stream, jax.random's default generator.
//
// Replaces avr_tpu/ops/pallas/rng.py:54 pallas_uniform_2d (call :67).  The
// TPU kernel draws from the TPU core's hardware generator, which exists on
// no other backend; everywhere else the JAX package computes the same call
// as jax.random.uniform (avr_tpu/ops/sampling.py:55-63), and so does this
// kernel, bit for bit:
//   element i of the draw (flat, row-major over the whole shape) has the
//   counter (hi, lo) = (i >> 32, i & 0xffffffff);
//   (x0, x1) = threefry2x32(key, (hi, lo)); bits = x0 ^ x1;
//   uniform = bitcast((bits >> 9) | 0x3f800000) - 1 (a 23-bit grid, never 1).
// The `bits` mode stores the word itself as an int64 in [0, 2^32)
// (jax.random.randint's raw draws).
//
// Bound on H100: integer operations.  An element costs 20 rounds of add,
// rotate and xor plus the key injections (~75 operations) for 4 bytes of
// output: at (4, 81,920) ~25 M operations at ~16.7 T int32 operations/s
// (132 SMs x 64 INT32 lanes x 1.98 GHz) is ~1.5 us, against 0.4 us of
// writes.  Design: one thread per element in a grid-stride loop over the
// 64-bit flat index, the key words as kernel arguments (the loop-invariant
// key schedule is hoisted), the rotations as funnel shifts, no shared
// memory.  The float conversion is an exact subtraction, so the kernel
// equals its plain version in every bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;  // grid-stride beyond 16 blocks an SM

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = rotl(x1, R);
  x1 ^= x0;
}

template <int A, int B, int C, int D>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  mix<A>(x0, x1);
  mix<B>(x0, x1);
  mix<C>(x0, x1);
  mix<D>(x0, x1);
}

// threefry2x32 with 20 rounds, as jax._src.prng._threefry2x32_lowering
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
}

template <bool UNIFORM>
__global__ void __launch_bounds__(THREADS)
threefry_kernel(uint32_t k0, uint32_t k1, long long n, void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    uint32_t x0 = (uint32_t)((unsigned long long)i >> 32);
    uint32_t x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    if (UNIFORM) {
      static_cast<float*>(out)[i] = __fsub_rn(__uint_as_float((bits >> 9) | 0x3f800000u), 1.f);
    } else {
      static_cast<long long*>(out)[i] = (long long)bits;
    }
  }
}

}  // namespace

// mode 0: uniform float32; mode 1: the raw words as int64
extern "C" int avr_threefry(unsigned int k0, unsigned int k1, long long n, int mode, void* out,
                            void* stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (mode == 0) {
    threefry_kernel<true><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(k0, k1, n, out);
  } else {
    threefry_kernel<false><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(k0, k1, n, out);
  }
  return (int)cudaGetLastError();
}
