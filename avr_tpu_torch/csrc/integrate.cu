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
// sizes, the launch and the latency of one load and one ray's arithmetic:
// the call is a few microseconds whatever the kernel does with its bytes.
//
// Forward (volume_integral_kernel<L>): four lanes a ray, eight rays a
// warp, four warps a CTA; no barrier spans warps.  A warp's rays read one
// contiguous run of z and of field rows (sample k of ray r is row r n + k),
// so the warp stages it into shared memory by cp.async, every 16-byte row
// and 4-byte z in flight at once, then waits for its own copies only: one
// warp composites while others' rows are still arriving.  Sample p of a
// group of 32 sits on lane p % 4 of the ray's four lanes, slot p / 4, and a
// lane holds L = ceil(min(n, 32) / 4) slots in registers (5 at the band's
// 20 samples: no slot idle).  The transmittance's exclusive product is the
// TPU kernel's doubling (integrate.py:126-131: step st multiplies t_p by
// t_{p-st}, steps 1, 2, 4, ... < n - 1): steps 1 and 2 shift across the
// ray's lanes, one shuffle a slot; steps 4, 8 and 16 are one, two and four
// slots back on the same lane.  Each lane adds its weights into the five
// sums (r, g, b, distance, acc) in slot order and the four lanes' sums meet
// in two xor shuffles.  Rays of more than 32 samples go in groups of 32,
// the product of the earlier groups carried in and multiplied in after the
// scan, as in the backward, so the transmittance agrees with the TPU
// kernel's to the last bits at n <= 32; the sums' order differs from the
// parent's.  The parent kernel took one warp a ray (12 of 32 lanes idle at
// n = 20; a shuffle scan and five 5-round butterfly sums, 29 shuffles a
// ray; 2,048 CTAs of 256 threads at the band, whose empty launch alone took
// 2.05 us on the card); here a warp composites 8 rays with 26 shuffles.
// Measured and dropped (PERF.md): a thread a ray (its serial walk), the CTA
// staging its rows behind one barrier, and 2 or 8 lanes a ray.
//
// Backward (volume_integral_bwd_kernel, unchanged since the first port):
// one warp per ray, eight rays per CTA; the warp walks the band in groups of
// 32 samples, lane k of group j holding sample 32 j + k (any n; the adaptive
// renderer's band has 20, the quality series' 2x epsilon sweep 40).  A lane
// reads its field row as one 16-byte load (a ray's rows are contiguous).
// Within a group the shifts are warp shuffles (across a group's end the next
// sample's z is loaded); the exclusive transmittance product is a
// Hillis-Steele scan over shuffle-up steps 1, 2, 4, ... (< the group's size
// - 1), the association of the TPU kernel's doubling, and the product of the
// earlier groups multiplies in after the scan.  Its exclusive suffix sum is
// the reversed scan, carried from the last group back: it walks the groups
// in reverse and recomputes each group's transmittance from the start of
// the band (n / 32 groups, each a few shuffles).  The TPU kernel's one-hot
// fold matrices exist because the TPU has no lane shifts; none are needed
// here.  q is computed as written, each operation rounded on its own (both
// kernels): a contraction that folds the 1e-10 into the 1 makes q exactly 0
// at a saturated lane (e = 0); the backward's max(q, 1e-10) guards that
// lane.

#include "common.cuh"

constexpr unsigned FULL = 0xffffffffu;
constexpr int RAYS = 8;  // the backward's rays (warps) per CTA

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

// --- forward: four lanes a ray, each warp staging its own rays' rows

constexpr int FWD_GROUP = 32;  // samples of a ray staged and composited at once
constexpr int FWD_LANES = 4;   // lanes a ray (2 and 8 measured slower on the card)
constexpr int FWD_WARP_RAYS = 32 / FWD_LANES;  // 8 rays a warp
constexpr int FWD_WARPS = 4;                   // warps a CTA: 32 rays
// The rows' pitch in shared memory, 32 + FWD_LANES (z and the field rows
// alike): ray i's sample k sits at i FWD_PITCH + k, so a warp's 8 rays x 4
// lanes read 32 distinct banks of z (4 i + lane mod 32), and a quarter
// warp's 8 threads 8 distinct 16-byte bank groups of the field rows; a
// ray's group (32 rows, and z's one more) fits its row.
constexpr int FWD_PITCH = FWD_GROUP + FWD_LANES;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}

// One warp copies rows [k0, k0 + m) of its `nr` rays (ray0 + i, row (ray0 +
// i) n + k0 + k of `src`) to dst[i pitch + k], ray-major: element e = i m +
// k, lane taking e = lane, lane + 32, ...  For n <= FWD_GROUP the rows are
// one contiguous run, read in order.
template <typename V>
__device__ __forceinline__ void stage_rows(V* dst, const V* __restrict__ src, long long ray0,
                                           int nr, int n, int k0, int m, int pitch, int lane) {
  const int di = 32 / m, dk = 32 - di * m;
  int i = lane / m, k = lane - i * m;
  for (int e = lane; e < nr * m; e += 32) {
    const V* s = src + (ray0 + i) * n + k0 + k;
    if constexpr (sizeof(V) == 16) cp_async16(dst + i * pitch + k, s);
    else cp_async4(dst + i * pitch + k, s);
    i += di;
    k += dk;
    if (k >= m) k -= m, ++i;
  }
}

// v shifted S < 4 positions up the ray's interleaved samples (position p =
// 4 l + j on lane j, slot l): out[l] on lane j is the value at position p -
// S, `fill` where that is below 0.  One shuffle a slot within the ray's four
// lanes; the senders at lanes 4 - S .. 3 send their previous slot.
template <int L, int S>
__device__ __forceinline__ void shift_up(const float (&v)[L], float (&out)[L], int j,
                                         float fill) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float send = j >= FWD_LANES - S ? (l > 0 ? v[l - 1] : fill) : v[l];
    out[l] = __shfl_sync(0xffffffffu, send, (j - S) & (FWD_LANES - 1), FWD_LANES);
  }
}

// The doubling's step ST: t_p *= t_{p - ST} (1 below 0: exact).  Steps 1
// and 2 cross the ray's lanes; from 4 on it is the same lane's slot ST / 4
// back, in descending slots (so t_{p - ST} is still the last step's
// value).  ST a template parameter, so t stays in registers.
template <int L, int ST>
__device__ __forceinline__ void doubling_step(float (&t)[L], int j) {
  if constexpr (ST < FWD_LANES) {
    float back[L];
    shift_up<L, ST>(t, back, j, 1.f);
#pragma unroll
    for (int l = 0; l < L; ++l) t[l] = __fmul_rn(t[l], back[l]);
  } else {
    constexpr int S = ST / FWD_LANES;
#pragma unroll
    for (int l = L - 1; l >= S; --l) t[l] = __fmul_rn(t[l], t[l - S]);
  }
}

// L: slots a lane holds, ceil(min(n, FWD_GROUP) / 4) (pick_fwd: 5 at the
// band's 20 samples).
template <int L>
__global__ void __launch_bounds__(FWD_WARPS * 32)
volume_integral_kernel(const float* __restrict__ z, const float4* __restrict__ fo,
                       float* __restrict__ rgb, float* __restrict__ dist, long long rays, int n,
                       int white_back, float infinity) {
  __shared__ __align__(16) float4 fs_all[FWD_WARPS][FWD_WARP_RAYS * FWD_PITCH];
  __shared__ float zs_all[FWD_WARPS][FWD_WARP_RAYS * FWD_PITCH];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = lane / FWD_LANES, j = lane % FWD_LANES;  // the warp's ray, the ray's lane
  float4* fs = fs_all[warp];
  float* zs = zs_all[warp];
  const long long ray0 = ((long long)blockIdx.x * FWD_WARPS + warp) * FWD_WARP_RAYS;
  if (ray0 >= rays) return;  // whole warps leave: no barrier spans warps
  const int nr = (int)min((long long)FWD_WARP_RAYS, rays - ray0);
  // this lane's sums over its slots and groups (a ray past nr computes on
  // whatever the shared rows hold and writes nothing: all 32 lanes take
  // part in every shuffle)
  float r = 0.f, g = 0.f, b = 0.f, d = 0.f, acc = 0.f, carry = 1.f;
  for (int k0 = 0; k0 < n; k0 += FWD_GROUP) {
    const int m = min(FWD_GROUP, n - k0);  // samples in this group
    __syncwarp();  // the last group's rows are read before this group's land
    // every row of the group in flight at once (z: one more, the next
    // group's first)
    stage_rows(fs, fo, ray0, nr, n, k0, m, FWD_PITCH, lane);
    stage_rows(zs, z, ray0, nr, n, k0, min(FWD_GROUP + 1, n - k0), FWD_PITCH, lane);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    // alpha and q of this lane's samples (slots past the group's end read
    // the row's other slots and are discarded below)
    const float4* fr = fs + i * FWD_PITCH;
    const float* zr = zs + i * FWD_PITCH;
    float al[L], q[L], t[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int k = FWD_LANES * l + j;
      const bool last = k0 + k == n - 1;
      const float delta = last ? 1e10f : __fsub_rn(zr[k + 1], zr[k]);
      const float e = expf(__fmul_rn(-fr[k].w, delta));
      al[l] = __fsub_rn(1.f, e);
      q[l] = __fadd_rn(__fsub_rn(1.f, al[l]), 1e-10f);
    }
    // the exclusive prefix product in the TPU kernel's doubling: t_p
    // starts as q_{p-1} (1 at p = 0), step st multiplies in t_{p-st} for
    // steps 1, 2, 4, ... < m - 1
    shift_up<L, 1>(q, t, j, 1.f);
    if (1 < m - 1) doubling_step<L, 1>(t, j);
    if (2 < m - 1) doubling_step<L, 2>(t, j);
    if (4 < m - 1) doubling_step<L, 4>(t, j);
    if (8 < m - 1) doubling_step<L, 8>(t, j);
    if (16 < m - 1) doubling_step<L, 16>(t, j);
    // weights and this lane's sums in slot order; the carry into the next
    // group: t q at the group's last sample
    const int kl = m - 1;
    float cand = 1.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int k = FWD_LANES * l + j;
      const float tk = k0 > 0 ? __fmul_rn(t[l], carry) : t[l];
      const float w = __fmul_rn(al[l], tk);
      const float4 f = fr[k];
      const float zz = k0 + k == n - 1 ? infinity : zr[k + 1];
      const bool on = k < m;
      r = on ? __fadd_rn(r, __fmul_rn(w, f.x)) : r;
      g = on ? __fadd_rn(g, __fmul_rn(w, f.y)) : g;
      b = on ? __fadd_rn(b, __fmul_rn(w, f.z)) : b;
      d = on ? __fadd_rn(d, __fmul_rn(w, zz)) : d;
      acc = on ? __fadd_rn(acc, w) : acc;
      if (k == kl) cand = __fmul_rn(tk, q[l]);
    }
    carry = __shfl_sync(0xffffffffu, cand, kl % FWD_LANES, FWD_LANES);
  }
  // the ray's sums: its lanes', in a fixed order
#pragma unroll
  for (int x = 1; x < FWD_LANES; x *= 2) {
    r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, x, FWD_LANES));
    g = __fadd_rn(g, __shfl_xor_sync(0xffffffffu, g, x, FWD_LANES));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, x, FWD_LANES));
    d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, x, FWD_LANES));
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, x, FWD_LANES));
  }
  if (j == 0 && i < nr) {
    const long long ray = ray0 + i;
    const float bg = white_back ? __fsub_rn(1.f, acc) : 0.f;
    rgb[ray * 3] = __fadd_rn(r, bg);
    rgb[ray * 3 + 1] = __fadd_rn(g, bg);
    rgb[ray * 3 + 2] = __fadd_rn(b, bg);
    dist[ray] = d;
  }
}

typedef void (*FwdKernel)(const float*, const float4*, float*, float*, long long, int, int,
                          float);

// The instantiation for l slots a lane (1 .. FWD_GROUP / FWD_LANES).
template <int L = 1>
static FwdKernel pick_fwd(int l) {
  if constexpr (L < FWD_GROUP / FWD_LANES)
    if (l > L) return pick_fwd<L + 1>(l);
  return volume_integral_kernel<L>;
}

// --- backward: one warp a ray (band_group), unchanged

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

// CTAs of FWD_WARPS warps, FWD_WARP_RAYS rays a warp.
extern "C" int avr_volume_integral(const void* z, const void* fo, void* rgb, void* dist,
                                   long long rays, int n, int white_back, float infinity,
                                   void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const FwdKernel kernel = pick_fwd((min(n, FWD_GROUP) + FWD_LANES - 1) / FWD_LANES);
  const long long cta_rays = FWD_WARPS * FWD_WARP_RAYS;
  kernel<<<(unsigned)((rays + cta_rays - 1) / cta_rays), FWD_WARPS * 32, 0,
           (cudaStream_t)stream>>>((const float*)z, (const float4*)fo, (float*)rgb, (float*)dist,
                                   rays, n, white_back, infinity);
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
