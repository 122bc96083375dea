// K4: fused band compositing (the adaptive renderer's volume integral),
// forward and backward.
//
// Replaces avr_tpu/ops/pallas/integrate.py:302 fused_volume_integral: the
// forward (_run_fwd, call :244) and its VJP (bwd, call :276).  Per ray of n
// band samples (z ascending; field rows point-major, sample k of ray r at
// row r * n + k, as the decoder writes them):
//   delta_k = z_{k+1} - z_k (the last 1e10), e_k = exp(-sigma_k delta_k),
//   alpha_k = 1 - e_k, q_k = 1 - alpha_k + 1e-10, T_k = prod_{j<k} q_j,
//   w_k = alpha_k T_k, rgb = sum w c (+ 1 - sum w with a white background),
//   distance = sum w zz with zz_k = z_{k+1} (the last: `infinity`).
// The backward recomputes all of it (only z and the field rows are saved)
// and applies the TPU kernel's closed form (integrate.py:173-198):
//   u_k = <c_k, g_rgb> + zz_k g_d (- sum g_rgb), S_k = sum_{j>k} w_j u_j,
//   d alpha_k = T_k u_k - S_k / max(q_k, 1e-10), d sigma = d alpha delta e,
//   d delta = d alpha sigma e (0 for the constant tail), and dz from the
//   two neighbours that read z_k.
//
// Bound on H100: bytes (train step's band call, 4 x 4,096 rays x 20: ~6.8 MB
// forward, ~2.0 us at 3.35 TB/s; ~13.4 MB backward, ~4.0 us) and, at these
// sizes, launch latency.  Design: one warp per ray, lane k holding sample k
// (n <= 32; the wrapper refuses more), eight rays per CTA.  A lane reads
// its field row as one 16-byte load (a ray's 20 rows are 320 contiguous
// bytes).  Shifts are warp shuffles; the exclusive transmittance product is
// a Hillis-Steele scan over shuffle-up steps 1, 2, 4, ... (< n - 1), the
// association of the TPU kernel's doubling (integrate.py:126-131), so the
// two agree to the last bits; the sums are butterfly reductions; the
// backward's suffix sum is the reversed scan.  The TPU kernel's one-hot fold
// matrices exist because the TPU has no lane shifts; none are needed here.
// q is computed as written, each operation rounded on its own: a
// contraction that folds the 1e-10 into the 1 makes q exactly 0 at a
// saturated lane (e = 0); the backward's max(q, 1e-10) guards that lane.

#include "common.cuh"

constexpr unsigned FULL = 0xffffffffu;
constexpr int RAYS = 8;  // rays (warps) per CTA

// One lane's sample after the forward recurrence (lanes >= n: zero weight).
struct Sample {
  float4 f;  // r, g, b, sigma
  float delta, zz, e, q, t, w;
  bool on, last;
};

__device__ __forceinline__ Sample band_forward(const float* __restrict__ z,
                                               const float4* __restrict__ fo, long long ray,
                                               int n, int lane, float infinity) {
  Sample s;
  s.on = lane < n;
  s.last = lane == n - 1;
  const float zk = s.on ? z[ray * n + lane] : 0.f;
  s.f = s.on ? fo[ray * n + lane] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float znext = __shfl_down_sync(FULL, zk, 1);
  s.delta = s.last ? 1e10f : __fsub_rn(znext, zk);
  s.zz = s.last ? infinity : znext;
  s.e = expf(__fmul_rn(-s.f.w, s.delta));
  const float alpha = __fsub_rn(1.f, s.e);
  s.q = __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f);
  // exclusive prefix product: t starts as q_{k-1} (1 at k = 0), each step
  // multiplies in the window one step further back
  float t = __shfl_up_sync(FULL, s.q, 1);
  if (lane == 0) t = 1.f;
  for (int st = 1; st < n - 1; st *= 2) {
    const float back = __shfl_up_sync(FULL, t, st);
    if (lane >= st) t = __fmul_rn(t, back);
  }
  s.t = t;
  s.w = s.on ? __fmul_rn(alpha, t) : 0.f;
  return s;
}

__global__ void __launch_bounds__(RAYS * 32)
volume_integral_kernel(const float* __restrict__ z, const float4* __restrict__ fo,
                       float* __restrict__ rgb, float* __restrict__ dist, long long rays, int n,
                       int white_back, float infinity) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * RAYS + (threadIdx.x >> 5);
  if (ray >= rays) return;  // whole warps leave together
  const Sample s = band_forward(z, fo, ray, n, lane, infinity);
  const float r = warp_sum(__fmul_rn(s.w, s.f.x));
  const float g = warp_sum(__fmul_rn(s.w, s.f.y));
  const float b = warp_sum(__fmul_rn(s.w, s.f.z));
  const float d = warp_sum(__fmul_rn(s.w, s.zz));
  const float acc = warp_sum(s.w);
  if (lane == 0) {
    const float bg = white_back ? __fsub_rn(1.f, acc) : 0.f;
    rgb[ray * 3] = __fadd_rn(r, bg);
    rgb[ray * 3 + 1] = __fadd_rn(g, bg);
    rgb[ray * 3 + 2] = __fadd_rn(b, bg);
    dist[ray] = d;
  }
}

__global__ void __launch_bounds__(RAYS * 32)
volume_integral_bwd_kernel(const float* __restrict__ z, const float4* __restrict__ fo,
                           const float* __restrict__ g_rgb, const float* __restrict__ g_dist,
                           float* __restrict__ dz, float4* __restrict__ dfo, long long rays, int n,
                           int white_back, float infinity) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * RAYS + (threadIdx.x >> 5);
  if (ray >= rays) return;
  const Sample s = band_forward(z, fo, ray, n, lane, infinity);
  const float gr = g_rgb[ray * 3], gg = g_rgb[ray * 3 + 1], gb = g_rgb[ray * 3 + 2];
  const float gd = g_dist[ray];
  // dL/dw_k through the colour, the distance and the white background
  float u = s.f.x * gr + s.f.y * gg + s.f.z * gb + s.zz * gd;
  if (white_back) u -= gr + gg + gb;
  // exclusive suffix sum S_k = sum_{j>k} w_j u_j: inclusive by shuffle-down
  // steps, then one lane down (lanes >= n add zero)
  float suf = s.on ? s.w * u : 0.f;
  for (int st = 1; st < 32; st *= 2) {
    const float ahead = __shfl_down_sync(FULL, suf, st);
    if (lane + st < 32) suf += ahead;
  }
  float S = __shfl_down_sync(FULL, suf, 1);
  if (lane == 31) S = 0.f;
  const float d_alpha = s.t * u - S / fmaxf(s.q, 1e-10f);
  const float d_sig = d_alpha * s.delta * s.e;
  const float d_delta = s.last ? 0.f : d_alpha * s.f.w * s.e;
  const float wgd = s.last ? 0.f : s.w * gd;
  // z_k feeds delta_{k-1} (+), delta_k (-) and zz_{k-1}
  float back = __shfl_up_sync(FULL, d_delta + wgd, 1);
  if (lane == 0) back = 0.f;
  if (s.on) {
    dz[ray * n + lane] = back - d_delta;
    dfo[ray * n + lane] = make_float4(s.w * gr, s.w * gg, s.w * gb, d_sig);
  }
}

extern "C" int avr_volume_integral(const void* z, const void* fo, void* rgb, void* dist,
                                   long long rays, int n, int white_back, float infinity,
                                   void* stream) {
  const long long blocks = (rays + RAYS - 1) / RAYS;
  volume_integral_kernel<<<(unsigned)blocks, RAYS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float4*)fo, (float*)rgb, (float*)dist, rays, n, white_back,
      infinity);
  return (int)cudaGetLastError();
}

extern "C" int avr_volume_integral_bwd(const void* z, const void* fo, const void* g_rgb,
                                       const void* g_dist, void* dz, void* dfo, long long rays,
                                       int n, int white_back, float infinity, void* stream) {
  const long long blocks = (rays + RAYS - 1) / RAYS;
  volume_integral_bwd_kernel<<<(unsigned)blocks, RAYS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float4*)fo, (const float*)g_rgb, (const float*)g_dist, (float*)dz,
      (float4*)dfo, rays, n, white_back, infinity);
  return (int)cudaGetLastError();
}
