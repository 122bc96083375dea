// K3: fused LSTM ray-march, forward and backward.
//
// Replaces avr_tpu/ops/pallas/march.py:703 fused_lstm_march: the forward
// (call :556) and its backward (call :621, kernel :381-521).  Per ray and
// step: project into each source view (packed scalars), 4-tap bilinear
// gather mean-pooled over views, LSTM cell (gates i, f, g, o), signed step
// s = h . w_out + b_out along the ray, optional early-stop freeze.
//
// Forward.  Bound on H100: neither FLOPs (~2.9 GFLOP) nor bytes (~4.3 MB)
// at 4,096 rays x 10 steps; the 10 dependent steps set the time.  One warp
// per ray, WARPS rays per CTA.  W_ih (C x 4H) and W_hh sit in shared memory
// for the CTA's rays; each step's gather reads 16-byte channel groups from
// L2 (the latent is a few MB) and blends them in registers; the float32
// carries (coords, h, c) stay on chip for all steps.  Under autograd the
// forward also writes one float32 row per ray and step (h_prev, c_prev,
// coords, active, the four gates, tanh c, s: AUXW floats, ~79 MB at
// 16,384 rays x 10 steps) for the backward.  A ray that froze stops: its
// coordinates cannot change (its later rows say active = 0).
//
// Backward.  Bound on H100: ~2.3e10 FLOP and ~67 MB of dfeat zeroing and
// writing, both ~0.02 ms; like the forward its time is the 10 dependent
// steps.  One warp per ray walks the steps in reverse from the saved rows:
// step head, the clip of the *combined* hidden cotangent to +-grad_clamp,
// the LSTM cell backward, dv = dgates @ W_ih^T, and the gather backward
// (float4 atomics into a zeroed float32 dfeat, per-tap dots into the
// coordinate cotangent with the strict border mask, then the projection).
// v_t is not saved by the forward: the backward loads the same four taps
// anyway for the per-tap dots, so it re-blends v_t from them (the latent
// stays in L2).  W_ih^T (4H x C) sits in shared memory for dv.
//
// Hidden sizes up to MAX_HIDDEN = 62, as the TPU kernel's 2H + 4 <= 128
// allows: lane k carries units k and k + 32 (the second only past 32), the
// gate row holds 4H <= 248 columns, and W_ih (W_ih^T in the backward) stays
// in shared memory while it fits there (C x 4H bf16 = 64 KB at H 16; 254 KB
// at H 62, read from L2 instead).  The weight
// cotangent dW_ih = sum over ray-steps of v_t (x) dgates is not summed in
// the walk (a first version did so by shared-memory atomics from all eight
// warps of a CTA on the same addresses, 1,024 a ray-step a lane: 39.5 ms):
// each ray-step writes v_t and its rounded gate cotangents (bf16, 189 MB
// at 16,384 rays x 10 steps) and one GEMM, the decoder's wgrad kernel
// (csrc/resnetfc.cu), sums them after.  The small weight cotangents (W_hh,
// biases, step head) sum in shared memory of persistent CTAs (one per SM)
// and reach global memory once per CTA.  A frozen step contributes exactly
// zero and is skipped.
#include "common.cuh"

constexpr int WARPS = 8;  // rays per CTA
constexpr int MAX_HIDDEN = 62;
constexpr int MAX_GATES = 256;  // 4 * hidden, hidden <= 62, padded
constexpr size_t WIH_SMEM_MAX = 128 * 1024;  // W_ih in shared memory up to this size

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Saved row per ray and step: [h_prev (H) | c_prev (H) | cx cy cz active |
// ig fg gg og (4H) | tanh c (H) | s], padded to a multiple of 4 floats.
__host__ __device__ inline int aux_g0(int hid) { return 2 * hid + 4; }
__host__ __device__ inline int aux_width(int hid) { return (7 * hid + 5 + 3) / 4 * 4; }

template <typename T> __host__ __device__ inline size_t wih_bytes(int C, int hid) {
  return align16((size_t)C * 4 * hid * sizeof(T));
}
template <typename T> __host__ __device__ inline bool wih_in_smem(int C, int hid) {
  return wih_bytes<T>(C, hid) <= WIH_SMEM_MAX;
}
// W_ih (when it fits) and W_hh in shared memory
template <typename T>
__host__ __device__ inline size_t weight_bytes(int C, int hid) {
  return (wih_in_smem<T>(C, hid) ? wih_bytes<T>(C, hid) : 0) +
         align16((size_t)hid * 4 * hid * sizeof(T));
}

// acc[gi] += sum_ch v[ch] W[ch][lane + 32 gi] over n rows of W (row stride
// G4): the gate columns this lane owns.  Inlined with W derived from the
// shared-memory pointer or the global one, so each loop reads its own space.
template <typename T, int GI>
__device__ __forceinline__ void gate_dots(const T* W, const float* v, int n, int G4, int lane,
                                          float (&acc)[GI]) {
  for (int ch = 0; ch < n; ++ch) {
    const float x = v[ch];
    const T* wrow = W + (size_t)ch * G4;
#pragma unroll
    for (int gi = 0; gi < GI; ++gi) {
      const int q = lane + 32 * gi;
      if (q < G4) acc[gi] = fmaf(x, to_f(wrow[q]), acc[gi]);
    }
  }
}

// GI: gate columns a lane owns (4: hidden <= 32; 8: up to MAX_HIDDEN)
template <typename T, int GI>
__global__ void __launch_bounds__(WARPS * 32)
lstm_march_kernel(const float* __restrict__ proj, const float* __restrict__ coords0,
                  const float* __restrict__ rds, const T* __restrict__ feat,
                  const T* __restrict__ w_ih, const T* __restrict__ w_hh,
                  const float* __restrict__ bias, const float* __restrict__ w_out,
                  const float* __restrict__ b_out, float* __restrict__ out,
                  float* __restrict__ aux, int SB, int R, int NS, int H, int W, int C, int hid,
                  int steps, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = Vec16<T>::N;
  const int G4 = 4 * hid;
  const bool wsm = wih_in_smem<T>(C, hid);  // else W_ih is read from L2
  T* whh_s = reinterpret_cast<T*>(smem + (wsm ? wih_bytes<T>(C, hid) : 0));
  float* v_s = reinterpret_cast<float*>(smem + weight_bytes<T>(C, hid));  // WARPS x C
  float* gate_s = v_s + WARPS * C;                                        // WARPS x 256
  float* h_s = gate_s + WARPS * MAX_GATES;                                // WARPS x 64
  float* bias_s = h_s + WARPS * 64;                                       // 256
  float* wout_s = bias_s + MAX_GATES;                                     // 64

  const int tid = threadIdx.x;
  const int n16 = C * G4 / V;
  if (wsm)
    for (int i = tid; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(smem)[i] = __ldg(reinterpret_cast<const uint4*>(w_ih) + i);
  for (int i = tid; i < hid * G4; i += blockDim.x) whh_s[i] = w_hh[i];
  for (int i = tid; i < G4; i += blockDim.x) bias_s[i] = bias[i];
  for (int i = tid; i < hid; i += blockDim.x) wout_s[i] = w_out[i];
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const long long ray = (long long)blockIdx.x * WARPS + warp;
  if (ray >= (long long)SB * R) return;  // no block-wide barrier follows
  const int sb = (int)(ray / R);
  float cx = coords0[ray * 3], cy = coords0[ray * 3 + 1], cz = coords0[ray * 3 + 2];
  const float rx = rds[ray * 3], ry = rds[ray * 3 + 1], rz = rds[ray * 3 + 2];
  float* v_w = v_s + warp * C;
  float* g_w = gate_s + warp * MAX_GATES;
  float* h_w = h_s + warp * 64;
  h_w[lane] = 0.f;
  h_w[lane + 32] = 0.f;
  float c_state[2] = {0.f, 0.f};  // lane k carries units k and k + 32 (< hid)
  const float bo = *b_out;
  const int groups = C / V;
  const float inv_ns = 1.f / (float)NS;
  const int AW = aux_width(hid), G0 = aux_g0(hid);
  __syncwarp();

  for (int step = 0; step < steps; ++step) {
    float* row = aux ? aux + ((size_t)ray * steps + step) * AW : nullptr;
    if (row && lane == 0) {
      row[2 * hid] = cx;
      row[2 * hid + 1] = cy;
      row[2 * hid + 2] = cz;
      row[2 * hid + 3] = 1.f;
    }
    // gather, summed over views into this warp's feature row
    for (int view = 0; view < NS; ++view) {
      const Projected q = project_point(proj + ((size_t)sb * NS + view) * 16, cx, cy, cz);
      const Taps tp = bilinear_taps(q.gx, q.gy, H, W);
      const T* base = feat + ((size_t)sb * NS + view) * H * W * C;
      for (int grp = lane; grp < groups; grp += 32) {
        float t00[V], t01[V], t10[V], t11[V];
        load16(base + (size_t)tp.i00 * C + grp * V, t00);
        load16(base + (size_t)tp.i01 * C + grp * V, t01);
        load16(base + (size_t)tp.i10 * C + grp * V, t10);
        load16(base + (size_t)tp.i11 * C + grp * V, t11);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float val = blend4(t00[j], t01[j], t10[j], t11[j], tp);
          const int ch = grp * V + j;
          v_w[ch] = view == 0 ? val : __fadd_rn(v_w[ch], val);
        }
      }
    }
    __syncwarp();  // the mean below reads channels another lane wrote
    // mean over views, rounded to the operand dtype
    for (int ch = lane; ch < C; ch += 32) {
      const float v = NS > 1 ? __fmul_rn(v_w[ch], inv_ns) : v_w[ch];
      v_w[ch] = round_to<T>(v);
    }
    __syncwarp();

    // gates: lane owns gate columns lane + 32 * gi
    float av[GI], ah[GI];
#pragma unroll
    for (int gi = 0; gi < GI; ++gi) av[gi] = ah[gi] = 0.f;
    if (wsm)
      gate_dots<T, GI>(reinterpret_cast<const T*>(smem), v_w, C, G4, lane, av);
    else
      gate_dots<T, GI>(w_ih, v_w, C, G4, lane, av);
    gate_dots<T, GI>(whh_s, h_w, hid, G4, lane, ah);
#pragma unroll
    for (int gi = 0; gi < GI; ++gi) {
      const int q = lane + 32 * gi;
      if (q < G4) g_w[q] = (av[gi] + ah[gi]) + bias_s[q];
    }
    __syncwarp();

    // cell: lane k updates units k and k + 32 (< hid); step head reduced
    // over the warp
    float part = 0.f;
#pragma unroll
    for (int uu = 0; uu < 2; ++uu) {
      const int u = lane + 32 * uu;
      if (u >= hid) continue;
      const float ig = sigmoidf_(g_w[u]);
      const float fg = sigmoidf_(g_w[hid + u]);
      const float gg = tanhf(g_w[2 * hid + u]);
      const float og = sigmoidf_(g_w[3 * hid + u]);
      const float c_prev = c_state[uu];
      c_state[uu] = fg * c_state[uu] + ig * gg;
      const float tc = tanhf(c_state[uu]);
      const float hn = round_to<T>(og * tc);
      if (row) {
        row[u] = h_w[u];
        row[hid + u] = c_prev;
        row[G0 + u] = ig;
        row[G0 + hid + u] = fg;
        row[G0 + 2 * hid + u] = gg;
        row[G0 + 3 * hid + u] = og;
        row[G0 + 4 * hid + u] = tc;
      }
      h_w[u] = hn;
      part = uu == 0 ? hn * wout_s[u] : part + hn * wout_s[u];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    // one value for the whole warp (xor sums may differ in the last bit)
    const float s = __shfl_sync(0xffffffffu, part, 0) + bo;
    cx = __fadd_rn(cx, __fmul_rn(rx, s));
    cy = __fadd_rn(cy, __fmul_rn(ry, s));
    cz = __fadd_rn(cz, __fmul_rn(rz, s));
    if (row && lane == 0) row[G0 + 5 * hid] = s;
    __syncwarp();
    if (eps > 0.f && fabsf(s) < eps) {  // frozen: s is 0 from now on
      if (aux && lane == 0)
        for (int t = step + 1; t < steps; ++t) aux[((size_t)ray * steps + t) * AW + 2 * hid + 3] = 0.f;
      break;
    }
  }
  if (lane == 0) {
    out[ray * 3] = cx;
    out[ray * 3 + 1] = cy;
    out[ray * 3 + 2] = cz;
  }
}

template <typename T>
static int launch(const void* proj, const void* coords0, const void* rds, const void* feat,
                  const void* w_ih, const void* w_hh, const void* bias, const void* w_out,
                  const void* b_out, void* out, void* aux, int SB, int R, int NS, int H, int W,
                  int C, int hid, int steps, float eps, cudaStream_t stream) {
  if (hid < 1 || hid > MAX_HIDDEN) return (int)cudaErrorInvalidValue;
  const size_t smem = weight_bytes<T>(C, hid) +
                      sizeof(float) * ((size_t)WARPS * (C + MAX_GATES + 64) + MAX_GATES + 64);
  auto kernel = hid <= 32 ? lstm_march_kernel<T, 4> : lstm_march_kernel<T, 8>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long rays = (long long)SB * R;
  const unsigned blocks = (unsigned)((rays + WARPS - 1) / WARPS);
  kernel<<<blocks, WARPS * 32, smem, stream>>>(
      (const float*)proj, (const float*)coords0, (const float*)rds, (const T*)feat,
      (const T*)w_ih, (const T*)w_hh, (const float*)bias, (const float*)w_out,
      (const float*)b_out, (float*)out, (float*)aux, SB, R, NS, H, W, C, hid, steps, eps);
  return (int)cudaGetLastError();
}

extern "C" int avr_lstm_march(const void* proj, const void* coords0, const void* rds,
                              const void* feat, const void* w_ih, const void* w_hh,
                              const void* bias, const void* w_out, const void* b_out, void* out,
                              void* aux, int SB, int R, int NS, int H, int W, int C, int hid,
                              int steps, float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(proj, coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out,
                                   out, aux, SB, R, NS, H, W, C, hid, steps, eps, s)
                    : launch<float>(proj, coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out,
                                    out, aux, SB, R, NS, H, W, C, hid, steps, eps, s);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct MarchBwdArgs {
  const float* proj;     // (SB, NS, 16)
  const float* rds;      // (SB * R, 3)
  const void* feat;      // (SB, NS, H, W, C) T
  const void* w_ihT;     // (4H, C) T: W_ih transposed, the dv operand
  const void* w_hh;      // (H, 4H) T
  const float* w_out;    // (H) rounded to T
  const float* aux;      // (SB * R, steps, AUXW)
  const float* gout;     // (SB * R, 3) cotangent of the final points
  float* dcoords0;       // (SB * R, 3)
  float* drds;           // (SB * R, 3)
  float* dfeat;          // (SB, NS, H, W, C) float32, zeroed
  void* vbuf;            // (SB * R, steps, C) T, zeroed: v_t, dW_ih's operand
  void* dgbuf;           // (SB * R, steps, dg_ld) T, zeroed: the rounded gate cotangents
  float* dw_hh;          // (H, 4H)
  float* dbias;          // (4H)
  float* dw_out;         // (H)
  float* db_out;         // (1)
  int SB, R, NS, H, W, C, hid, steps, dg_ld;
  float eps, clamp;
};

template <typename T>
__host__ __device__ inline size_t bwd_smem_bytes(int C, int hid) {
  const int G4 = 4 * hid;
  return (wih_in_smem<T>(C, hid) ? wih_bytes<T>(C, hid) : 0) +
         sizeof(float) * (2 * WARPS * C + WARPS * MAX_GATES + (size_t)hid * G4 + G4 + hid + 1);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32, 1) lstm_march_bwd_kernel(MarchBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hid = a.hid, G4 = 4 * hid, C = a.C, NS = a.NS;
  const bool wsm = wih_in_smem<T>(C, hid);
  const T* wihT_s = wsm ? reinterpret_cast<const T*>(smem)
                        : static_cast<const T*>(a.w_ihT);  // 4H x C; else from L2
  float* v_s = reinterpret_cast<float*>(smem + (wsm ? wih_bytes<T>(C, hid) : 0));  // WARPS x C
  float* dv_s = v_s + WARPS * C;                   // WARPS x C: dv rounded, / NS
  float* dg_s = dv_s + WARPS * C;                  // WARPS x 256: rounded dgates
  float* dwhh_s = dg_s + WARPS * MAX_GATES;        // H x 4H
  float* db_s = dwhh_s + hid * G4;                 // 4H
  float* dwout_s = db_s + G4;                      // H
  float* dbout_s = dwout_s + hid;                  // 1
  const int n_acc = 2 * WARPS * C + WARPS * MAX_GATES + hid * G4 + G4 + hid + 1;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) v_s[i] = 0.f;
  constexpr int V = Vec16<T>::N;
  if (wsm)
    for (int i = threadIdx.x; i < G4 * C / V; i += blockDim.x)
      reinterpret_cast<uint4*>(smem)[i] = __ldg(reinterpret_cast<const uint4*>(a.w_ihT) + i);
  __syncthreads();

  const T* feat = static_cast<const T*>(a.feat);
  const T* w_hh = static_cast<const T*>(a.w_hh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int AW = aux_width(hid), G0 = aux_g0(hid);
  const float inv_ns = 1.f / (float)NS;
  float* v_w = v_s + warp * C;
  float* dv_w = dv_s + warp * C;
  float* dg_w = dg_s + warp * MAX_GATES;
  const float wo[2] = {lane < hid ? a.w_out[lane] : 0.f,
                       lane + 32 < hid ? a.w_out[lane + 32] : 0.f};
  const long long rays = (long long)a.SB * a.R;

  for (long long ray = (long long)blockIdx.x * WARPS + warp; ray < rays;
       ray += (long long)gridDim.x * WARPS) {
    const int sb = (int)(ray / a.R);
    float gcx = a.gout[ray * 3], gcy = a.gout[ray * 3 + 1], gcz = a.gout[ray * 3 + 2];
    const float rx = a.rds[ray * 3], ry = a.rds[ray * 3 + 1], rz = a.rds[ray * 3 + 2];
    float grx = 0.f, gry = 0.f, grz = 0.f;
    float gh[2] = {0.f, 0.f}, gcell[2] = {0.f, 0.f};  // lane k: units k and k + 32
    for (int t = a.steps - 1; t >= 0; --t) {
      const float* row = a.aux + ((size_t)ray * a.steps + t) * AW;
      if (row[2 * hid + 3] == 0.f) continue;  // frozen: contributes exactly zero
      const float cx = row[2 * hid], cy = row[2 * hid + 1], cz = row[2 * hid + 2];
      const float s = row[G0 + 5 * hid];
      // coords_{t+1} = coords_t + rds * s
      const float ds = gcx * rx + gcy * ry + gcz * rz;
      grx += gcx * s;
      gry += gcy * s;
      grz += gcz * s;
      if (lane == 0) atomicAdd(dbout_s, ds);
#pragma unroll
      for (int uu = 0; uu < 2; ++uu) {
        const int u = lane + 32 * uu;
        if (u >= hid) continue;
        const float ig = row[G0 + u], fg = row[G0 + hid + u];
        const float gg = row[G0 + 2 * hid + u], og = row[G0 + 3 * hid + u];
        const float tc = row[G0 + 4 * hid + u], c_prev = row[hid + u];
        atomicAdd(dwout_s + u, round_to<T>(og * tc) * round_to<T>(ds));
        // the clip acts on the combined hidden cotangent (step head + next step);
        // a NaN passes through it, as through jnp.clip and torch.clamp (fminf
        // and fmaxf alone would turn it into -clamp)
        const float gsum = gh[uu] + ds * wo[uu];
        const float ghc = isnan(gsum) ? gsum : fminf(fmaxf(gsum, -a.clamp), a.clamp);
        const float gct = gcell[uu] + ghc * og * (1.f - tc * tc);
        const float d4[4] = {gct * gg * ig * (1.f - ig), gct * c_prev * fg * (1.f - fg),
                             gct * ig * (1.f - gg * gg), ghc * tc * og * (1.f - og)};
        gcell[uu] = gct * fg;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          atomicAdd(db_s + k * hid + u, d4[k]);
          dg_w[k * hid + u] = round_to<T>(d4[k]);
        }
      }
      __syncwarp();
      // dW_hh += h_prev (x) dgates; the h cotangent of step t-1
      for (int k = 0; k < hid; ++k) {
        const float hp = round_to<T>(row[k]);
        for (int q = lane; q < G4; q += 32) atomicAdd(dwhh_s + k * G4 + q, hp * dg_w[q]);
      }
#pragma unroll
      for (int uu = 0; uu < 2; ++uu) {
        const int u = lane + 32 * uu;
        if (u >= hid) continue;
        float acc = 0.f;
        for (int q = 0; q < G4; ++q) acc = fmaf(dg_w[q], to_f(w_hh[u * G4 + q]), acc);
        gh[uu] = acc;
      }
      // the rounded gate cotangents: dW_ih's other operand (a GEMM after this kernel)
      T* dg_row = static_cast<T*>(a.dgbuf) + ((size_t)ray * a.steps + t) * a.dg_ld;
      for (int q = lane; q < G4; q += 32) dg_row[q] = from_f<T>(dg_w[q]);
      // dv = dgates @ W_ih^T for this lane's channels (W_ih^T rows in shared
      // memory, 16-byte reads), rounded, / NS
      for (int ch = lane * V; ch < C; ch += 32 * V) {
        float acc[V];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = 0.f;
        for (int q = 0; q < G4; ++q) {
          float w[V];
          load16_shared(wihT_s + (size_t)q * C + ch, w);
          const float d = dg_w[q];
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(d, w[j], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) dv_w[ch + j] = round_to<T>(NS > 1 ? acc[j] * inv_ns : acc[j]);
      }
      // gather backward per view; v_t re-blended from the same taps
      for (int view = 0; view < NS; ++view) {
        const float* p = a.proj + ((size_t)sb * NS + view) * 16;
        const Projected q = project_point(p, cx, cy, cz);
        const Taps tp = bilinear_taps(q.gx, q.gy, a.H, a.W);
        const size_t map = ((size_t)sb * NS + view) * a.H * a.W * C;
        const T* base = feat + map;
        float* dbase = a.dfeat + map;
        const int idx[4] = {tp.i00, tp.i01, tp.i10, tp.i11};
        const float w[4] = {round_to<T>(tp.w00), round_to<T>(tp.w01), round_to<T>(tp.w10),
                            round_to<T>(tp.w11)};
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        for (int ch = lane * V; ch < C; ch += 32 * V) {
          float tap[4][V];
#pragma unroll
          for (int k = 0; k < 4; ++k) load16(base + (size_t)idx[k] * C + ch, tap[k]);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float val = blend4(tap[0][j], tap[1][j], tap[2][j], tap[3][j], tp);
            v_w[ch + j] = view == 0 ? val : __fadd_rn(v_w[ch + j], val);
#pragma unroll
            for (int k = 0; k < 4; ++k) dot[k] = fmaf(dv_w[ch + j], tap[k][j], dot[k]);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (w[k] != 0.f) atomic_add_scaled(dbase + (size_t)idx[k] * C + ch, dv_w + ch, w[k], V);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) dot[k] = __shfl_sync(0xffffffffu, warp_sum(dot[k]), 0);
        const float2 dgrid = tap_coord_grad(dot[0], dot[1], dot[2], dot[3], tp, q.gx, q.gy, a.H,
                                            a.W);
        const float3 dw = project_point_bwd(p, q, dgrid);
        gcx += dw.x;
        gcy += dw.y;
        gcz += dw.z;
      }
      // v_t, rounded as the forward rounded it: dW_ih's operand
      T* v_row = static_cast<T*>(a.vbuf) + ((size_t)ray * a.steps + t) * C;
      for (int ch = lane * V; ch < C; ch += 32 * V) {
        float v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = NS > 1 ? __fmul_rn(v_w[ch + j], inv_ns) : v_w[ch + j];
        store16(v_row + ch, v);
      }
      __syncwarp();  // v_w, dv_w and dg_w are rewritten by the next step
    }
    if (lane == 0) {
      a.dcoords0[ray * 3] = gcx;
      a.dcoords0[ray * 3 + 1] = gcy;
      a.dcoords0[ray * 3 + 2] = gcz;
      a.drds[ray * 3] = grx;
      a.drds[ray * 3 + 1] = gry;
      a.drds[ray * 3 + 2] = grz;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hid * G4; i += blockDim.x) atomicAdd(a.dw_hh + i, dwhh_s[i]);
  for (int i = threadIdx.x; i < G4; i += blockDim.x) atomicAdd(a.dbias + i, db_s[i]);
  for (int i = threadIdx.x; i < hid; i += blockDim.x) atomicAdd(a.dw_out + i, dwout_s[i]);
  if (threadIdx.x == 0) atomicAdd(a.db_out, dbout_s[0]);
}

template <typename T>
static int launch_bwd(const MarchBwdArgs& a, cudaStream_t stream) {
  if (a.hid < 1 || a.hid > MAX_HIDDEN || a.dg_ld < 4 * a.hid) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes<T>(a.C, a.hid);
  cudaError_t e = cudaFuncSetAttribute(lstm_march_bwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const long long rays = (long long)a.SB * a.R;
  const long long need = (rays + WARPS - 1) / WARPS;
  const unsigned blocks = (unsigned)(need < sms ? need : sms);
  lstm_march_bwd_kernel<T><<<blocks, WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int avr_lstm_march_bwd(const void* proj, const void* rds, const void* feat,
                                  const void* w_ihT, const void* w_hh, const void* w_out,
                                  const void* aux, const void* gout, void* dcoords0, void* drds,
                                  void* dfeat, void* vbuf, void* dgbuf, void* dw_hh, void* dbias,
                                  void* dw_out, void* db_out, int SB, int R, int NS, int H, int W,
                                  int C, int hid, int steps, int dg_ld, float eps, float clamp,
                                  int dtype, void* stream) {
  MarchBwdArgs a;
  a.proj = (const float*)proj; a.rds = (const float*)rds; a.feat = feat; a.w_ihT = w_ihT;
  a.w_hh = w_hh; a.w_out = (const float*)w_out; a.aux = (const float*)aux;
  a.gout = (const float*)gout; a.dcoords0 = (float*)dcoords0; a.drds = (float*)drds;
  a.dfeat = (float*)dfeat; a.vbuf = vbuf; a.dgbuf = dgbuf; a.dw_hh = (float*)dw_hh;
  a.dbias = (float*)dbias; a.dw_out = (float*)dw_out; a.db_out = (float*)db_out;
  a.SB = SB; a.R = R; a.NS = NS; a.H = H; a.W = W; a.C = C; a.hid = hid; a.steps = steps;
  a.dg_ld = dg_ld; a.eps = eps; a.clamp = clamp;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_bwd<bf16>(a, s) : launch_bwd<float>(a, s);
}
