// Shared device helpers for the avr_tpu_torch kernels (sm_90a).
//
// Element types: float and __nv_bfloat16.  Loads and stores move 16 bytes
// (4 floats or 8 bf16) per thread; arithmetic is float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float32 to T and back: the value a product consumes as an operand.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T> struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

// 16 bytes of T at p (16-byte aligned) -> Vec16<T>::N floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* out) {
  uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 16 bytes of T from shared memory (load16 reads global memory through
// the read-only path).
__device__ __forceinline__ void load16_shared(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16_shared(const bf16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float* in) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// Bilinear taps of one grid point, align_corners=True with border clamp,
// exactly avr_tpu/ops/grid_sample.py.  Every operation is rounded on its
// own (_rn intrinsics: no FMA contraction), in the order the plain PyTorch
// version computes it, so the two agree bit for bit.
struct Taps {
  int i00, i01, i10, i11;
  float w00, w01, w10, w11;
  float wx, wy;  // fractional offsets (the backward's weight derivatives)
};

__device__ __forceinline__ Taps bilinear_taps(float gx, float gy, int H, int W) {
  float x = __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f), (float)(W - 1));
  float y = __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f), (float)(H - 1));
  x = fminf(fmaxf(x, 0.f), (float)(W - 1));
  y = fminf(fmaxf(y, 0.f), (float)(H - 1));
  float x0 = floorf(x), y0 = floorf(y);
  float wx = __fsub_rn(x, x0), wy = __fsub_rn(y, y0);
  int x0i = (int)x0, y0i = (int)y0;
  int x1i = min(x0i + 1, W - 1), y1i = min(y0i + 1, H - 1);
  Taps t;
  t.i00 = y0i * W + x0i;
  t.i01 = y0i * W + x1i;
  t.i10 = y1i * W + x0i;
  t.i11 = y1i * W + x1i;
  t.wx = wx;
  t.wy = wy;
  float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
  t.w00 = __fmul_rn(uy, ux);
  t.w01 = __fmul_rn(uy, wx);
  t.w10 = __fmul_rn(wy, ux);
  t.w11 = __fmul_rn(wy, wx);
  return t;
}

// ((t00*w00 + t01*w01) + t10*w10) + t11*w11, each step rounded.
__device__ __forceinline__ float blend4(float a, float b, float c, float d, const Taps& t) {
  float s = __fadd_rn(__fmul_rn(a, t.w00), __fmul_rn(b, t.w01));
  s = __fadd_rn(s, __fmul_rn(c, t.w10));
  return __fadd_rn(s, __fmul_rn(d, t.w11));
}

// A world point in one view through its 16 packed projection scalars
// [R (9) | t (3) | fg (2) | cg (2)] (ops/kernels/march.py pack_projection):
// cam = R x + t, grid = -(cam_xy / cam_z) * fg + cg.  Every operation is
// rounded on its own, in the order of the plain PyTorch version
// (ops/kernels/gather.py project_packed), so the grids agree bit for bit.
struct Projected {
  float gx, gy, camx, camy, camz;
};

__device__ __forceinline__ Projected project_point(const float* p, float x, float y, float z) {
  Projected q;
  q.camx = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[0], x), __fmul_rn(p[1], y)),
                               __fmul_rn(p[2], z)), p[9]);
  q.camy = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[3], x), __fmul_rn(p[4], y)),
                               __fmul_rn(p[5], z)), p[10]);
  q.camz = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[6], x), __fmul_rn(p[7], y)),
                               __fmul_rn(p[8], z)), p[11]);
  q.gx = __fadd_rn(__fmul_rn(-__fdiv_rn(q.camx, q.camz), p[12]), p[14]);
  q.gy = __fadd_rn(__fmul_rn(-__fdiv_rn(q.camy, q.camz), p[13]), p[15]);
  return q;
}

// World-point cotangent of the grid cotangent dgrid: grid -> camera ->
// world (R^T on the camera cotangent).
__device__ __forceinline__ float3 project_point_bwd(const float* p, const Projected& q,
                                                    float2 dgrid) {
  const float inv_z = 1.f / q.camz;
  const float dcamx = -dgrid.x * p[12] * inv_z;
  const float dcamy = -dgrid.y * p[13] * inv_z;
  const float dcamz = (dgrid.x * p[12] * q.camx + dgrid.y * p[13] * q.camy) * inv_z * inv_z;
  return make_float3(p[0] * dcamx + p[3] * dcamy + p[6] * dcamz,
                     p[1] * dcamx + p[4] * dcamy + p[7] * dcamz,
                     p[2] * dcamx + p[5] * dcamy + p[8] * dcamz);
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// Strict live mask of the border clamp's derivative: 1 only for an
// unclamped pixel coordinate strictly inside (0, S - 1), as the TPU
// kernels' backward (avr_tpu/ops/pallas/gather.py:142-148).
__device__ __forceinline__ float live(float g, int S) {
  const float u = __fmul_rn(__fmul_rn(__fadd_rn(g, 1.f), 0.5f), (float)(S - 1));
  return (u > 0.f && u < (float)(S - 1)) ? 1.f : 0.f;
}

// Coordinate cotangent of one bilinear sample from the per-tap dots
// <g, f_tap>: (d grid_x, d grid_y).
__device__ __forceinline__ float2 tap_coord_grad(float gf0, float gf1, float gf2, float gf3,
                                                 const Taps& t, float gx, float gy, int H,
                                                 int W) {
  const float d_wx = (gf1 - gf0) * (1.f - t.wy) + (gf3 - gf2) * t.wy;
  const float d_wy = (gf2 - gf0) * (1.f - t.wx) + (gf3 - gf1) * t.wx;
  return make_float2(d_wx * live(gx, W) * (0.5f * (float)(W - 1)),
                     d_wy * live(gy, H) * (0.5f * (float)(H - 1)));
}

// p[0..n) += v[0..n) * s in float32 by global atomics (n = 4 or 8, p
// 16-byte aligned); sm_90 adds four floats per atomic.
__device__ __forceinline__ void atomic_add_scaled(float* p, const float* v, float s, int n) {
  for (int i = 0; i < n; i += 4) {
#if CUDART_VERSION >= 12030
    atomicAdd(reinterpret_cast<float4*>(p + i),
              make_float4(v[i] * s, v[i + 1] * s, v[i + 2] * s, v[i + 3] * s));
#else
    for (int j = 0; j < 4; ++j) atomicAdd(p + i + j, v[i + j] * s);
#endif
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// --- tensor-core building blocks (mma.sync, sm_80 and later)

// Four 8 x 8 b16 matrices from shared memory (lane i gives row i % 8 of
// matrix i / 8); `trans` transposes each.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p, bool trans) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// d (m16 n8, float32) += a (m16 k16, bf16, row) * b (k16 n8, bf16, col)
__device__ __forceinline__ void mma_m16n8k16(float* d, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
