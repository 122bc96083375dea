// K1: bilinear latent gather (forward).
//
// Replaces avr_tpu/ops/pallas/gather.py:395 gather_bilinear_windowed.
// Semantics: F.grid_sample(align_corners=True, padding_mode="border") on
// an NHWC map, float32 blend, output in the map's dtype.
//
// Bound on H100: bytes (band shape: ~84 MB written vs a 4.2 MB latent that
// stays in L2).  Design: one thread per (point, 16-byte channel group);
// the 32 threads of a warp read neighbouring channel groups of the same
// taps, so every tap read and the output write are coalesced 16-byte
// accesses.  The TPU kernel's one-hot MXU selectors and row windows are
// not needed: a tap is a plain load.

#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(256)
gather_bilinear_kernel(const T* __restrict__ feat, const float* __restrict__ coords,
                       T* __restrict__ out, int H, int W, int C, int N, long long total) {
  constexpr int V = Vec16<T>::N;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int groups = C / V;
  const int grp = (int)(i % groups);
  const long long pt = i / groups;  // over B * N
  const int b = (int)(pt / N);
  const float2 g = reinterpret_cast<const float2*>(coords)[pt];
  const Taps tp = bilinear_taps(g.x, g.y, H, W);
  const T* base = feat + (size_t)b * H * W * C + (size_t)grp * V;
  float t00[V], t01[V], t10[V], t11[V], r[V];
  load16(base + (size_t)tp.i00 * C, t00);
  load16(base + (size_t)tp.i01 * C, t01);
  load16(base + (size_t)tp.i10 * C, t10);
  load16(base + (size_t)tp.i11 * C, t11);
#pragma unroll
  for (int j = 0; j < V; ++j) r[j] = blend4(t00[j], t01[j], t10[j], t11[j], tp);
  store16(out + (size_t)pt * C + (size_t)grp * V, r);
}

template <typename T>
static int launch(const void* feat, const void* coords, void* out, int B, int H, int W,
                  int C, int N, cudaStream_t stream) {
  const long long total = (long long)B * N * (C / Vec16<T>::N);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  gather_bilinear_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)feat, (const float*)coords, (T*)out, H, W, C, N, total);
  return (int)cudaGetLastError();
}

extern "C" int avr_gather_bilinear(const void* feat, const void* coords, void* out, int B,
                                   int H, int W, int C, int N, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(feat, coords, out, B, H, W, C, N, s)
                    : launch<float>(feat, coords, out, B, H, W, C, N, s);
}
