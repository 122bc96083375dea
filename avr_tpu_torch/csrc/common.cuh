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

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }
