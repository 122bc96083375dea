// K1: bilinear latent gather, forward and backward.
//
// Replaces avr_tpu/ops/pallas/gather.py:395 gather_bilinear_windowed
// (forward) and its VJP _wbwd (gather.py:447, kernel math :102-151).
// Semantics: F.grid_sample(align_corners=True, padding_mode="border") on
// an NHWC map, float32 blend, output in the map's dtype.
//
// Forward.  Bound on H100: bytes (band shape: ~84 MB written vs a 4.2 MB
// latent that stays in L2).  One thread per (point, 16-byte channel group);
// the 32 threads of a warp read neighbouring channel groups of the same
// taps, so every tap read and the output write are coalesced 16-byte
// accesses.  The TPU kernel's one-hot MXU selectors and row windows are
// not needed: a tap is a plain load.
//
// Backward.  Bound on H100: bytes (band call ~425 MB: g, the taps, the
// zeroed and written float32 map, coords; ~0.13 ms).  One warp per point:
// 16-byte loads of g and of the four taps, float32 dots <g, f_tap> reduced
// by shuffles into the coordinate cotangent (strict border mask), and
// dfeat += w_tap * g (both rounded to the map's dtype, as the TPU kernel's
// operands are) by float4 atomics into a zeroed float32 map.  A ray's band
// samples share pixels, so those atomics contend.

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

template <typename T>
__global__ void __launch_bounds__(256)
gather_bilinear_bwd_kernel(const T* __restrict__ feat, const float* __restrict__ coords,
                           const T* __restrict__ g, float* __restrict__ dfeat,
                           float* __restrict__ dcoords, int H, int W, int C, int N,
                           long long points) {
  constexpr int V = Vec16<T>::N;
  const int lane = threadIdx.x & 31;
  const long long pt = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (pt >= points) return;  // whole warps leave together
  const int b = (int)(pt / N);
  const float2 gc = reinterpret_cast<const float2*>(coords)[pt];
  const Taps tp = bilinear_taps(gc.x, gc.y, H, W);
  const size_t map = (size_t)b * H * W * C;
  const T* fb = feat + map;
  float* db = dfeat + map;
  const int idx[4] = {tp.i00, tp.i01, tp.i10, tp.i11};
  const float w[4] = {round_to<T>(tp.w00), round_to<T>(tp.w01), round_to<T>(tp.w10),
                      round_to<T>(tp.w11)};
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ch = lane * V; ch < C; ch += 32 * V) {
    float gv[V], f[V];
    load16(g + (size_t)pt * C + ch, gv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      load16(fb + (size_t)idx[k] * C + ch, f);
#pragma unroll
      for (int j = 0; j < V; ++j) dot[k] = fmaf(gv[j], f[j], dot[k]);
      if (w[k] != 0.f) atomic_add_scaled(db + (size_t)idx[k] * C + ch, gv, w[k], V);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dot[k] = warp_sum(dot[k]);
  if (lane == 0) {
    const float2 d = tap_coord_grad(dot[0], dot[1], dot[2], dot[3], tp, gc.x, gc.y, H, W);
    reinterpret_cast<float2*>(dcoords)[pt] = d;
  }
}

template <typename T>
static int launch_bwd(const void* feat, const void* coords, const void* g, void* dfeat,
                      void* dcoords, int B, int H, int W, int C, int N, cudaStream_t stream) {
  const long long points = (long long)B * N;
  const int threads = 256;
  const long long blocks = (points * 32 + threads - 1) / threads;
  gather_bilinear_bwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)feat, (const float*)coords, (const T*)g, (float*)dfeat, (float*)dcoords, H, W,
      C, N, points);
  return (int)cudaGetLastError();
}

extern "C" int avr_gather_bilinear_bwd(const void* feat, const void* coords, const void* g,
                                       void* dfeat, void* dcoords, int B, int H, int W, int C,
                                       int N, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_bwd<bf16>(feat, coords, g, dfeat, dcoords, B, H, W, C, N, s)
                    : launch_bwd<float>(feat, coords, g, dfeat, dcoords, B, H, W, C, N, s);
}

extern "C" int avr_gather_bilinear(const void* feat, const void* coords, void* out, int B,
                                   int H, int W, int C, int N, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(feat, coords, out, B, H, W, C, N, s)
                    : launch<float>(feat, coords, out, B, H, W, C, N, s);
}
