// K3: fused LSTM ray-march (forward).
//
// Replaces avr_tpu/ops/pallas/march.py:703 fused_lstm_march.  Per ray and
// step: project into each source view (packed scalars), 4-tap bilinear
// gather mean-pooled over views, LSTM cell (gates i, f, g, o), signed step
// s = h . w_out + b_out along the ray, optional early-stop freeze.
//
// Bound on H100: neither FLOPs (~2.9 GFLOP) nor bytes (~4.3 MB) at 4,096
// rays x 10 steps; the 10 dependent steps set the time.  Design: one warp
// per ray, WARPS rays per CTA.  W_ih (C x 4H) and W_hh sit in shared memory
// for the CTA's rays; each step's gather reads 16-byte channel groups from
// L2 (the latent is a few MB) and blends them in registers; the float32
// carries (coords, h, c) stay on chip for all steps and no per-step stash
// is written.  A ray that froze stops: its coordinates cannot change.

#include "common.cuh"

constexpr int WARPS = 8;  // rays per CTA
constexpr int MAX_GATES = 128;  // 4 * hidden, hidden <= 32

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T>
__host__ __device__ inline size_t weight_bytes(int C, int hid) {
  return align16((size_t)C * 4 * hid * sizeof(T)) + align16((size_t)hid * 4 * hid * sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
lstm_march_kernel(const float* __restrict__ proj, const float* __restrict__ coords0,
                  const float* __restrict__ rds, const T* __restrict__ feat,
                  const T* __restrict__ w_ih, const T* __restrict__ w_hh,
                  const float* __restrict__ bias, const float* __restrict__ w_out,
                  const float* __restrict__ b_out, float* __restrict__ out, int SB, int R,
                  int NS, int H, int W, int C, int hid, int steps, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = Vec16<T>::N;
  const int G4 = 4 * hid;
  T* wih_s = reinterpret_cast<T*>(smem);
  T* whh_s = reinterpret_cast<T*>(smem + align16((size_t)C * G4 * sizeof(T)));
  float* v_s = reinterpret_cast<float*>(smem + weight_bytes<T>(C, hid));  // WARPS x C
  float* gate_s = v_s + WARPS * C;                                        // WARPS x 128
  float* h_s = gate_s + WARPS * MAX_GATES;                                // WARPS x 32
  float* bias_s = h_s + WARPS * 32;                                       // 128
  float* wout_s = bias_s + MAX_GATES;                                     // 32

  const int tid = threadIdx.x;
  const int n16 = C * G4 / V;
  for (int i = tid; i < n16; i += blockDim.x)
    reinterpret_cast<uint4*>(wih_s)[i] = __ldg(reinterpret_cast<const uint4*>(w_ih) + i);
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
  float* h_w = h_s + warp * 32;
  h_w[lane] = 0.f;
  float c_state = 0.f;  // lane k < hid carries unit k
  const float bo = *b_out;
  const int groups = C / V;
  const float inv_ns = 1.f / (float)NS;
  __syncwarp();

  for (int step = 0; step < steps; ++step) {
    // gather, summed over views into this warp's feature row
    for (int view = 0; view < NS; ++view) {
      const float* p = proj + ((size_t)sb * NS + view) * 16;
      const float camx = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[0], cx), __fmul_rn(p[1], cy)),
                                             __fmul_rn(p[2], cz)), p[9]);
      const float camy = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[3], cx), __fmul_rn(p[4], cy)),
                                             __fmul_rn(p[5], cz)), p[10]);
      const float camz = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[6], cx), __fmul_rn(p[7], cy)),
                                             __fmul_rn(p[8], cz)), p[11]);
      const float gx = __fadd_rn(__fmul_rn(-__fdiv_rn(camx, camz), p[12]), p[14]);
      const float gy = __fadd_rn(__fmul_rn(-__fdiv_rn(camy, camz), p[13]), p[15]);
      const Taps tp = bilinear_taps(gx, gy, H, W);
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
    float av[4] = {0.f, 0.f, 0.f, 0.f}, ah[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = 0; ch < C; ++ch) {
      const float v = v_w[ch];
      const T* wrow = wih_s + (size_t)ch * G4;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        const int q = lane + 32 * gi;
        if (q < G4) av[gi] = fmaf(v, to_f(wrow[q]), av[gi]);
      }
    }
    for (int k = 0; k < hid; ++k) {
      const float hk = h_w[k];
      const T* wrow = whh_s + k * G4;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        const int q = lane + 32 * gi;
        if (q < G4) ah[gi] = fmaf(hk, to_f(wrow[q]), ah[gi]);
      }
    }
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      const int q = lane + 32 * gi;
      if (q < G4) g_w[q] = (av[gi] + ah[gi]) + bias_s[q];
    }
    __syncwarp();

    // cell: lane k < hid updates unit k; step head reduced over the warp
    float part = 0.f;
    if (lane < hid) {
      const float ig = sigmoidf_(g_w[lane]);
      const float fg = sigmoidf_(g_w[hid + lane]);
      const float gg = tanhf(g_w[2 * hid + lane]);
      const float og = sigmoidf_(g_w[3 * hid + lane]);
      c_state = fg * c_state + ig * gg;
      const float hn = round_to<T>(og * tanhf(c_state));
      h_w[lane] = hn;
      part = hn * wout_s[lane];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    // one value for the whole warp (xor sums may differ in the last bit)
    const float s = __shfl_sync(0xffffffffu, part, 0) + bo;
    cx = __fadd_rn(cx, __fmul_rn(rx, s));
    cy = __fadd_rn(cy, __fmul_rn(ry, s));
    cz = __fadd_rn(cz, __fmul_rn(rz, s));
    __syncwarp();
    if (eps > 0.f && fabsf(s) < eps) break;  // frozen: s is 0 from now on
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
                  const void* b_out, void* out, int SB, int R, int NS, int H, int W, int C,
                  int hid, int steps, float eps, cudaStream_t stream) {
  const size_t smem = weight_bytes<T>(C, hid) +
                      sizeof(float) * ((size_t)WARPS * (C + MAX_GATES + 32) + MAX_GATES + 32);
  cudaError_t e = cudaFuncSetAttribute(lstm_march_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long rays = (long long)SB * R;
  const unsigned blocks = (unsigned)((rays + WARPS - 1) / WARPS);
  lstm_march_kernel<T><<<blocks, WARPS * 32, smem, stream>>>(
      (const float*)proj, (const float*)coords0, (const float*)rds, (const T*)feat,
      (const T*)w_ih, (const T*)w_hh, (const float*)bias, (const float*)w_out,
      (const float*)b_out, (float*)out, SB, R, NS, H, W, C, hid, steps, eps);
  return (int)cudaGetLastError();
}

extern "C" int avr_lstm_march(const void* proj, const void* coords0, const void* rds,
                              const void* feat, const void* w_ih, const void* w_hh,
                              const void* bias, const void* w_out, const void* b_out, void* out,
                              int SB, int R, int NS, int H, int W, int C, int hid, int steps,
                              float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(proj, coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out,
                                   out, SB, R, NS, H, W, C, hid, steps, eps, s)
                    : launch<float>(proj, coords0, rds, feat, w_ih, w_hh, bias, w_out, b_out,
                                    out, SB, R, NS, H, W, C, hid, steps, eps, s);
}
