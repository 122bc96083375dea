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
// sizes, launch latency.  Design: one warp per ray, eight rays per CTA; the
// warp walks the band in groups of 32 samples, lane k of group j holding
// sample 32 j + k (any n; the adaptive renderer's band has 20, the quality
// series' 2x epsilon sweep 40).  A lane reads its field row as one 16-byte
// load (a ray's rows are contiguous).  Within a group the shifts are warp
// shuffles (across a group's end the next sample's z is loaded); the exclusive
// transmittance product is a Hillis-Steele scan over shuffle-up steps 1, 2,
// 4, ... (< the group's size - 1), the association of the TPU kernel's
// doubling (integrate.py:126-131), so the two agree to the last bits at n <=
// 32, and the product of the earlier groups multiplies in after the scan;
// the sums are butterfly reductions added group by group.  The backward's
// exclusive suffix sum is the reversed scan, carried from the last group
// back: it walks the groups in reverse and recomputes each group's
// transmittance from the start of the band (n / 32 groups, each a few
// shuffles).  The TPU kernel's one-hot fold matrices exist because the TPU
// has no lane shifts; none are needed here.  q is computed as written, each
// operation rounded on its own: a contraction that folds the 1e-10 into the
// 1 makes q exactly 0 at a saturated lane (e = 0); the backward's max(q,
// 1e-10) guards that lane.

#include "common.cuh"

constexpr unsigned FULL = 0xffffffffu;
constexpr int RAYS = 8;  // rays (warps) per CTA

// One lane's sample after the forward recurrence (samples >= n: zero weight).
struct Sample {
  float4 f;  // r, g, b, sigma
  float delta, zz, e, q, t, w;
  bool on, last;
};

// Sample k = k0 + lane of the band, with carry the product of q over the
// samples before k0; also returns (in carry) the product through the group.
__device__ __forceinline__ Sample band_group(const float* __restrict__ z,
                                             const float4* __restrict__ fo, long long ray,
                                             int n, int k0, int lane, float infinity,
                                             float& carry) {
  Sample s;
  const int k = k0 + lane, m = min(32, n - k0);  // samples in this group
  s.on = k < n;
  s.last = k == n - 1;
  const float zk = s.on ? z[ray * n + k] : 0.f;
  // the next sample's z: the next lane's, or across the group's end a load
  float znext = __shfl_down_sync(FULL, zk, 1);
  if (lane == 31 && k + 1 < n) znext = z[ray * n + k + 1];
  s.f = s.on ? fo[ray * n + k] : make_float4(0.f, 0.f, 0.f, 0.f);
  s.delta = s.last ? 1e10f : __fsub_rn(znext, zk);
  s.zz = s.last ? infinity : znext;
  s.e = expf(__fmul_rn(-s.f.w, s.delta));
  const float alpha = __fsub_rn(1.f, s.e);
  s.q = __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f);
  // exclusive prefix product within the group: t starts as q_{k-1} (1 at
  // the group's first lane), each step multiplies in the window one step
  // further back; then the earlier groups' product
  float t = __shfl_up_sync(FULL, s.q, 1);
  if (lane == 0) t = 1.f;
  for (int st = 1; st < m - 1; st *= 2) {
    const float back = __shfl_up_sync(FULL, t, st);
    if (lane >= st) t = __fmul_rn(t, back);
  }
  if (k0 > 0) t = __fmul_rn(t, carry);
  s.t = t;
  s.w = s.on ? __fmul_rn(alpha, t) : 0.f;
  carry = __shfl_sync(FULL, __fmul_rn(t, s.q), m - 1);
  return s;
}

__global__ void __launch_bounds__(RAYS * 32)
volume_integral_kernel(const float* __restrict__ z, const float4* __restrict__ fo,
                       float* __restrict__ rgb, float* __restrict__ dist, long long rays, int n,
                       int white_back, float infinity) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * RAYS + (threadIdx.x >> 5);
  if (ray >= rays) return;  // whole warps leave together
  float r = 0.f, g = 0.f, b = 0.f, d = 0.f, acc = 0.f, carry = 1.f;
  for (int k0 = 0; k0 < n; k0 += 32) {
    const Sample s = band_group(z, fo, ray, n, k0, lane, infinity, carry);
    r += warp_sum(__fmul_rn(s.w, s.f.x));
    g += warp_sum(__fmul_rn(s.w, s.f.y));
    b += warp_sum(__fmul_rn(s.w, s.f.z));
    d += warp_sum(__fmul_rn(s.w, s.zz));
    acc += warp_sum(s.w);
  }
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
  const float gr = g_rgb[ray * 3], gg = g_rgb[ray * 3 + 1], gb = g_rgb[ray * 3 + 2];
  const float gd = g_dist[ray];
  float after = 0.f;  // sum of w u over the groups after this one
  const int groups = (n + 31) / 32;
  for (int j = groups - 1; j >= 0; --j) {
    // the transmittance entering group j, recomputed from the band's start
    float carry = 1.f;
    for (int i = 0; i < j; ++i) band_group(z, fo, ray, n, 32 * i, lane, infinity, carry);
    const Sample s = band_group(z, fo, ray, n, 32 * j, lane, infinity, carry);
    // dL/dw_k through the colour, the distance and the white background
    float u = s.f.x * gr + s.f.y * gg + s.f.z * gb + s.zz * gd;
    if (white_back) u -= gr + gg + gb;
    // exclusive suffix sum S_k = sum_{i>k} w_i u_i: inclusive by
    // shuffle-down steps within the group, then one lane down, plus the
    // later groups (lanes past the band add zero)
    float suf = s.on ? s.w * u : 0.f;
    for (int st = 1; st < 32; st *= 2) {
      const float ahead = __shfl_down_sync(FULL, suf, st);
      if (lane + st < 32) suf += ahead;
    }
    const float total = __shfl_sync(FULL, suf, 0);
    float S = __shfl_down_sync(FULL, suf, 1);
    if (lane == 31) S = 0.f;
    if (j < groups - 1) S += after;
    after += total;
    const float d_alpha = s.t * u - S / fmaxf(s.q, 1e-10f);
    const float d_sig = d_alpha * s.delta * s.e;
    const float d_delta = s.last ? 0.f : d_alpha * s.f.w * s.e;
    const float wgd = s.last ? 0.f : s.w * gd;
    // z_k feeds delta_{k-1} (+), delta_k (-) and zz_{k-1}; across a group
    // boundary the previous group's last lane adds its share (below)
    float back = __shfl_up_sync(FULL, d_delta + wgd, 1);
    if (lane == 0) back = 0.f;
    const int k = 32 * j + lane;
    if (s.on) {
      dz[ray * n + k] = back - d_delta;
      dfo[ray * n + k] = make_float4(s.w * gr, s.w * gg, s.w * gb, d_sig);
    }
    // sample 32 (j + 1) takes this group's last share, now that it is written
    const float share = __shfl_sync(FULL, d_delta + wgd, 31);
    __syncwarp();
    if (lane == 0 && j < groups - 1) dz[ray * n + k + 32] += share;
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
