// K1: bilinear latent gather, forward and backward; K5: the same gather at
// the projection of world points, forward and backward.
//
// K1 replaces avr_tpu/ops/pallas/gather.py:395 gather_bilinear_windowed
// (forward) and its VJP _wbwd (gather.py:447, kernel math :102-151), and
// with them gather.py:164 gather_bilinear and its VJP _bwd (:207), the same
// function on the full map.  Semantics: F.grid_sample(align_corners=True,
// padding_mode="border") on an NHWC map, float32 blend, output in the map's
// dtype.
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
//
// K5 replaces gather.py:642 gather_bilinear_projected (forward, call :669)
// and its VJP _pbwd (:699, call :712): world points (B, N, 3) and each
// view's 16 packed projection scalars in, the grid computed in the kernel
// (project_point, common.cuh) and K1's gather at it.  Bound: K1's bytes
// plus 12 B a point of world points (and 12 B of their cotangent
// backward).  A block serves one view (blockIdx.y) and holds its 16
// scalars in shared memory.  Forward: the block's first threads project its
// points once each into shared-memory taps, then K1's one thread per
// (point, channel group).  Backward: K1's one warp per point, then the grid
// cotangent is chained through the projection to the world point
// (project_point_bwd); the projection scalars get no cotangent (cameras are
// conditioning, as in the TPU kernel).  The TPU kernel's in-kernel row
// windows only feed its one-hot selectors; there are none here.

#include "common.cuh"

constexpr int THREADS = 256;

// One point's 16-byte channel group: blend the four taps of the map `base`
// (already offset to the group) into `out`.
template <typename T>
__device__ __forceinline__ void gather_group(const T* base, const Taps& tp, int C, T* out) {
  constexpr int V = Vec16<T>::N;
  float t00[V], t01[V], t10[V], t11[V], r[V];
  load16(base + (size_t)tp.i00 * C, t00);
  load16(base + (size_t)tp.i01 * C, t01);
  load16(base + (size_t)tp.i10 * C, t10);
  load16(base + (size_t)tp.i11 * C, t11);
#pragma unroll
  for (int j = 0; j < V; ++j) r[j] = blend4(t00[j], t01[j], t10[j], t11[j], tp);
  store16(out, r);
}

// One point's backward by a whole warp: dfeat += w_tap * g over the point's
// C channels (float atomics into the float32 map `db`), and the grid
// cotangent from the per-tap dots <g, f_tap>, returned to every lane.
template <typename T>
__device__ __forceinline__ float2 gather_point_bwd(const T* fb, float* db, const T* gp,
                                                   const Taps& tp, float gx, float gy, int H,
                                                   int W, int C, int lane) {
  constexpr int V = Vec16<T>::N;
  const int idx[4] = {tp.i00, tp.i01, tp.i10, tp.i11};
  const float w[4] = {round_to<T>(tp.w00), round_to<T>(tp.w01), round_to<T>(tp.w10),
                      round_to<T>(tp.w11)};
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ch = lane * V; ch < C; ch += 32 * V) {
    float gv[V], f[V];
    load16(gp + ch, gv);
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
  return tap_coord_grad(dot[0], dot[1], dot[2], dot[3], tp, gx, gy, H, W);
}

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
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
  gather_group(feat + (size_t)b * H * W * C + (size_t)grp * V, bilinear_taps(g.x, g.y, H, W), C,
               out + (size_t)pt * C + (size_t)grp * V);
}

template <typename T>
static int launch(const void* feat, const void* coords, void* out, int B, int H, int W,
                  int C, int N, cudaStream_t stream) {
  const long long total = (long long)B * N * (C / Vec16<T>::N);
  const long long blocks = (total + THREADS - 1) / THREADS;
  gather_bilinear_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)feat, (const float*)coords, (T*)out, H, W, C, N, total);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_bilinear_bwd_kernel(const T* __restrict__ feat, const float* __restrict__ coords,
                           const T* __restrict__ g, float* __restrict__ dfeat,
                           float* __restrict__ dcoords, int H, int W, int C, int N,
                           long long points) {
  const int lane = threadIdx.x & 31;
  const long long pt = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (pt >= points) return;  // whole warps leave together
  const int b = (int)(pt / N);
  const float2 gc = reinterpret_cast<const float2*>(coords)[pt];
  const size_t map = (size_t)b * H * W * C;
  const float2 d = gather_point_bwd(feat + map, dfeat + map, g + (size_t)pt * C,
                                    bilinear_taps(gc.x, gc.y, H, W), gc.x, gc.y, H, W, C, lane);
  if (lane == 0) reinterpret_cast<float2*>(dcoords)[pt] = d;
}

template <typename T>
static int launch_bwd(const void* feat, const void* coords, const void* g, void* dfeat,
                      void* dcoords, int B, int H, int W, int C, int N, cudaStream_t stream) {
  const long long points = (long long)B * N;
  const long long blocks = (points * 32 + THREADS - 1) / THREADS;
  gather_bilinear_bwd_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
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

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// Forward: block (x, b) serves points [x * pts, x * pts + pts) of view b,
// pts = max(1, THREADS / channel groups).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_projected_kernel(const T* __restrict__ feat, const float* __restrict__ points,
                        const float* __restrict__ proj, T* __restrict__ out, int H, int W,
                        int C, int N, int pts) {
  constexpr int V = Vec16<T>::N;
  __shared__ float p_s[16];
  __shared__ Taps taps_s[THREADS];
  const int b = blockIdx.y, tid = threadIdx.x;
  if (tid < 16) p_s[tid] = proj[(size_t)b * 16 + tid];
  __syncthreads();
  const long long p0 = (long long)blockIdx.x * pts;
  const int np = (int)min((long long)pts, (long long)N - p0);
  if (tid < np) {
    const float* x = points + ((size_t)b * N + p0 + tid) * 3;
    const Projected q = project_point(p_s, x[0], x[1], x[2]);
    taps_s[tid] = bilinear_taps(q.gx, q.gy, H, W);
  }
  __syncthreads();
  const int groups = C / V;
  const T* map = feat + (size_t)b * H * W * C;
  T* ob = out + ((size_t)b * N + p0) * C;
  for (int item = tid; item < np * groups; item += THREADS) {
    const int pt = item / groups, grp = item % groups;
    gather_group(map + (size_t)grp * V, taps_s[pt], C, ob + (size_t)pt * C + (size_t)grp * V);
  }
}

template <typename T>
static int launch_projected(const void* feat, const void* points, const void* proj, void* out,
                            int B, int H, int W, int C, int N, cudaStream_t stream) {
  const int groups = C / Vec16<T>::N;
  const int pts = groups >= THREADS ? 1 : THREADS / groups;
  const dim3 grid((unsigned)((N + pts - 1) / pts), (unsigned)B);
  gather_projected_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)feat, (const float*)points, (const float*)proj, (T*)out, H, W, C, N, pts);
  return (int)cudaGetLastError();
}

// Backward: block (x, b) serves points [x * 8, x * 8 + 8) of view b, one
// warp each.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_projected_bwd_kernel(const T* __restrict__ feat, const float* __restrict__ points,
                            const float* __restrict__ proj, const T* __restrict__ g,
                            float* __restrict__ dfeat, float* __restrict__ dpoints, int H, int W,
                            int C, int N) {
  __shared__ float p_s[16];
  const int b = blockIdx.y;
  if (threadIdx.x < 16) p_s[threadIdx.x] = proj[(size_t)b * 16 + threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps leave together
  const size_t pt = (size_t)b * N + n;
  const float* x = points + pt * 3;
  const Projected q = project_point(p_s, x[0], x[1], x[2]);
  const size_t map = (size_t)b * H * W * C;
  const float2 dgrid = gather_point_bwd(feat + map, dfeat + map, g + pt * C,
                                        bilinear_taps(q.gx, q.gy, H, W), q.gx, q.gy, H, W, C,
                                        lane);
  if (lane == 0) {
    const float3 d = project_point_bwd(p_s, q, dgrid);
    dpoints[pt * 3] = d.x;
    dpoints[pt * 3 + 1] = d.y;
    dpoints[pt * 3 + 2] = d.z;
  }
}

template <typename T>
static int launch_projected_bwd(const void* feat, const void* points, const void* proj,
                                const void* g, void* dfeat, void* dpoints, int B, int H, int W,
                                int C, int N, cudaStream_t stream) {
  constexpr int warps = THREADS / 32;
  const dim3 grid((unsigned)((N + warps - 1) / warps), (unsigned)B);
  gather_projected_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)feat, (const float*)points, (const float*)proj, (const T*)g, (float*)dfeat,
      (float*)dpoints, H, W, C, N);
  return (int)cudaGetLastError();
}

extern "C" int avr_gather_projected(const void* feat, const void* points, const void* proj,
                                    void* out, int B, int H, int W, int C, int N, int dtype,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_projected<bf16>(feat, points, proj, out, B, H, W, C, N, s)
                    : launch_projected<float>(feat, points, proj, out, B, H, W, C, N, s);
}

extern "C" int avr_gather_projected_bwd(const void* feat, const void* points, const void* proj,
                                        const void* g, void* dfeat, void* dpoints, int B, int H,
                                        int W, int C, int N, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? launch_projected_bwd<bf16>(feat, points, proj, g, dfeat, dpoints, B, H, W, C, N, s)
             : launch_projected_bwd<float>(feat, points, proj, g, dfeat, dpoints, B, H, W, C, N,
                                           s);
}
