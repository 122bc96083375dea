// K2: fused FC-ResNet field decoder (forward).
//
// Replaces avr_tpu/ops/pallas/resnetfc.py:896 fused_resnetfc (forward
// kernel :726).  Per point: positional-encoding prologue from a per-column
// table; per source view lin_in + n_lin_z (latent injection + residual
// block); mean over views; remaining blocks; relu -> lin_out; optional
// sigmoid(rgb) / relu(sigma).  Trunk h in float32; matmul operands in T
// (bf16 or float32) with float32 accumulation.
//
// Bound on H100: operations (~6.9 MFLOP per point; ~0.57 ms per 81,920-point
// band chunk at the bf16 tensor-core peak, against ~28 us of compulsory
// bytes).  Design (first version, simple): one CTA per TM = 32 points,
// d_hidden / 64 warps, each warp owning 64 output columns of every
// product.  The trunk lives in registers in the mma accumulator layout; the
// current operand tile (encoding, activation) and the latent tile live in
// shared memory, so no (N, 512) activation reaches device memory.  Weights
// (~6.8 MB in bf16, more than shared memory holds) are read from L2 with
// 16-byte loads in nn.Linear (out, in) layout, which is exactly the
// column-major B fragment of mma.sync.m16n8k16.  bf16 products run on the
// tensor cores; float32 operands take a plain FMA loop with the same
// fragment ownership.
//
// Fragment layout of acc[mt][nt][i] for lane (g = lane / 4, t = lane % 4):
// row mt*16 + g + 8*(i >> 1), column col0 + nt*8 + 2*t + (i & 1).
// Within each 32-wide k slab a thread reads k = 8t..8t+7 of its A rows and
// B columns with one 16-byte load each and feeds them to two m16n8k16
// steps; the k order inside a product is a consistent permutation of A and
// B, so the product is unchanged.

#include "common.cuh"

constexpr int TM = 32;  // points per CTA

struct FcArgs {
  const float* x;       // (ns, N, d_in) float32 raw (or already encoded) inputs
  const void* z;        // (ns, N, d_latent) T
  const void* wi;       // (dh, k_in) T, zero-padded columns
  const float* bi;      // (dh)
  const void* wz;       // (n_lin_z, dh, d_latent) T
  const float* bz;      // (n_lin_z, dh)
  const void* w0;       // (n_blocks, dh, dh) T
  const float* b0;      // (n_blocks, dh)
  const void* w1;       // (n_blocks, dh, dh) T
  const float* b1;      // (n_blocks, dh)
  const void* wo;       // (d_out, dh) T
  const float* bo;      // (d_out)
  const int* tables;    // (2, k_in): column mode (0 raw, 1 sin, 2 zero), source lane
  const float* fph;     // (2, k_in): frequency, phase
  float* out;           // (N, d_out)
  int N, ns, d_in, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z, activate;
};

// Shared-memory row stride (elements) of a K-wide tile.  bf16: rows 64
// bytes apart modulo 128, so the 16-byte fragment loads of 8 lanes hit 8
// distinct bank groups.
template <typename T> __host__ __device__ inline int row_stride(int k);
template <> __host__ __device__ inline int row_stride<bf16>(int k) { return (k + 63) / 64 * 64 + 32; }
template <> __host__ __device__ inline int row_stride<float>(int k) { return k + 4; }

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

typedef float Frag[2][8][4];

// acc = A (TM x K, shared) @ W^T for this warp's 64 columns; W is (dh, K).
__device__ __forceinline__ void gemm_tile(const bf16* As, int lda, const bf16* __restrict__ W,
                                          int K, int col0, Frag& acc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    uint4 a[2][2], b[8];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      a[mt][0] = *reinterpret_cast<const uint4*>(As + (mt * 16 + g) * lda + k0 + 8 * t);
      a[mt][1] = *reinterpret_cast<const uint4*>(As + (mt * 16 + g + 8) * lda + k0 + 8 * t);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      b[nt] = __ldg(reinterpret_cast<const uint4*>(W + (size_t)(col0 + nt * 8 + g) * K + k0 + 8 * t));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][nt], a[mt][0].x, a[mt][1].x, a[mt][0].y, a[mt][1].y, b[nt].x, b[nt].y);
        mma_bf16(acc[mt][nt], a[mt][0].z, a[mt][1].z, a[mt][0].w, a[mt][1].w, b[nt].z, b[nt].w);
      }
  }
}

__device__ __forceinline__ void gemm_tile(const float* As, int lda, const float* __restrict__ W,
                                          int K, int col0, Frag& acc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 4) {
    float4 a[4];  // rows g, g + 8, 16 + g, 24 + g
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(As + ((r >> 1) * 16 + g + 8 * (r & 1)) * lda + k0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(
            W + (size_t)(col0 + nt * 8 + 2 * t + cc) * K + k0));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const float4 av = a[2 * mt + hi];
            float& d = acc[mt][nt][2 * hi + cc];
            d = fmaf(av.x, w.x, d);
            d = fmaf(av.y, w.y, d);
            d = fmaf(av.z, w.z, d);
            d = fmaf(av.w, w.w, d);
          }
      }
  }
}

__device__ __forceinline__ int frag_row(int mt, int i) {
  return mt * 16 + ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int frag_col(int col0, int nt, int i) {
  return col0 + nt * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}

// relu(v) rounded to T into the shared operand tile.
template <typename T>
__device__ __forceinline__ void store_relu(T* As, int lda, int col0, const Frag& v) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        As[frag_row(mt, i) * lda + frag_col(col0, nt, i)] = from_f<T>(fmaxf(v[mt][nt][i], 0.f));
}

// h = h + relu(relu(h) @ W0^T + b0) @ W1^T + b1
template <typename T>
__device__ __forceinline__ void res_block(T* As, int lda, const T* w0, const float* b0, const T* w1,
                          const float* b1, int dh, int col0, Frag& h, Frag& acc) {
  __syncthreads();  // every warp is done reading the operand tile
  store_relu<T>(As, lda, col0, h);
  __syncthreads();
  gemm_tile(As, lda, w0, dh, col0, acc);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = acc[mt][nt][i] + b0[frag_col(col0, nt, i)];
  __syncthreads();
  store_relu<T>(As, lda, col0, acc);
  __syncthreads();
  gemm_tile(As, lda, w1, dh, col0, acc);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h[mt][nt][i] = (h[mt][nt][i] + acc[mt][nt][i]) + b1[frag_col(col0, nt, i)];
}

template <typename T>
__global__ void __launch_bounds__(256, 1) resnetfc_kernel(FcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = Vec16<T>::N;
  const int dh = a.d_hidden, dl = a.d_latent;
  const int lda = row_stride<T>(max(a.k_in, dh)), ldz = row_stride<T>(dl);
  T* As = reinterpret_cast<T*>(smem);
  T* Zs = As + TM * lda;
  float* Hs = reinterpret_cast<float*>(Zs + TM * ldz);  // view sum, ns > 1 only
  const int tid = threadIdx.x, col0 = (tid >> 5) * 64;
  const int r0 = blockIdx.x * TM;
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  Frag h, acc;

  for (int v = 0; v < a.ns; ++v) {
    __syncthreads();  // the previous view is done with both tiles
    for (int idx = tid; idx < TM * a.k_in; idx += blockDim.x) {
      const int r = idx / a.k_in, j = idx - r * a.k_in, row = r0 + r;
      const int mode = a.tables[j];
      float val = 0.f;
      if (row < a.N && mode != 2) {
        const float p = a.x[((size_t)v * a.N + row) * a.d_in + a.tables[a.k_in + j]];
        val = mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[a.k_in + j]));
      }
      As[r * lda + j] = from_f<T>(val);
    }
    const int nv = dl / V;
    const T* zg = static_cast<const T*>(a.z) + ((size_t)v * a.N + r0) * dl;
    for (int idx = tid; idx < TM * nv; idx += blockDim.x) {
      const int r = idx / nv, cv = idx - r * nv;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < a.N) val = __ldg(reinterpret_cast<const uint4*>(zg + (size_t)r * dl) + cv);
      *reinterpret_cast<uint4*>(Zs + r * ldz + cv * V) = val;
    }
    __syncthreads();

    gemm_tile(As, lda, static_cast<const T*>(a.wi), a.k_in, col0, acc);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) h[mt][nt][i] = acc[mt][nt][i] + a.bi[frag_col(col0, nt, i)];
    for (int k = 0; k < a.n_lin_z; ++k) {
      gemm_tile(Zs, ldz, wz + (size_t)k * dh * dl, dl, col0, acc);
      const float* bz = a.bz + (size_t)k * dh;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            h[mt][nt][i] = (h[mt][nt][i] + acc[mt][nt][i]) + bz[frag_col(col0, nt, i)];
      res_block<T>(As, lda, w0 + (size_t)k * dh * dh, a.b0 + (size_t)k * dh,
                   w1 + (size_t)k * dh * dh, a.b1 + (size_t)k * dh, dh, col0, h, acc);
    }
    if (a.ns > 1) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float& s = Hs[frag_row(mt, i) * dh + frag_col(col0, nt, i)];
            s = v == 0 ? h[mt][nt][i] : s + h[mt][nt][i];
          }
    }
  }
  if (a.ns > 1) {
    const float inv = 1.f / (float)a.ns;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[mt][nt][i] = Hs[frag_row(mt, i) * dh + frag_col(col0, nt, i)] * inv;
  }
  for (int k = a.n_lin_z; k < a.n_blocks; ++k)
    res_block<T>(As, lda, w0 + (size_t)k * dh * dh, a.b0 + (size_t)k * dh,
                 w1 + (size_t)k * dh * dh, a.b1 + (size_t)k * dh, dh, col0, h, acc);

  // epilogue: relu -> lin_out (d_out is small: one thread per output)
  __syncthreads();
  store_relu<T>(As, lda, col0, h);
  __syncthreads();
  const T* wo = static_cast<const T*>(a.wo);
  for (int idx = tid; idx < TM * a.d_out; idx += blockDim.x) {
    const int r = idx / a.d_out, o = idx - r * a.d_out, row = r0 + r;
    if (row >= a.N) continue;
    const T* arow = As + r * lda;
    const T* wrow = wo + (size_t)o * dh;
    float s = 0.f;
    for (int k = 0; k < dh; ++k) s = fmaf(to_f(arow[k]), to_f(wrow[k]), s);
    s = s + a.bo[o];
    if (a.activate) s = o < 3 ? sigmoidf_(s) : fmaxf(s, 0.f);
    a.out[(size_t)row * a.d_out + o] = s;
  }
}

template <typename T>
static int launch(const FcArgs& a, cudaStream_t stream) {
  const size_t smem =
      (size_t)TM * (row_stride<T>(a.k_in > a.d_hidden ? a.k_in : a.d_hidden) +
                    row_stride<T>(a.d_latent)) * sizeof(T) +
      (a.ns > 1 ? (size_t)TM * a.d_hidden * sizeof(float) : 0);
  cudaError_t e = cudaFuncSetAttribute(resnetfc_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((a.N + TM - 1) / TM);
  resnetfc_kernel<T><<<blocks, a.d_hidden / 64 * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int avr_resnetfc(const void* x, const void* z, const void* wi, const void* bi,
                            const void* wz, const void* bz, const void* w0, const void* b0,
                            const void* w1, const void* b1, const void* wo, const void* bo,
                            const void* tables, const void* fph, void* out, int N, int ns,
                            int d_in, int k_in, int d_latent, int d_hidden, int d_out,
                            int n_blocks, int n_lin_z, int activate, int dtype, void* stream) {
  FcArgs a;
  a.x = (const float*)x; a.z = z; a.wi = wi; a.bi = (const float*)bi;
  a.wz = wz; a.bz = (const float*)bz; a.w0 = w0; a.b0 = (const float*)b0;
  a.w1 = w1; a.b1 = (const float*)b1; a.wo = wo; a.bo = (const float*)bo;
  a.tables = (const int*)tables; a.fph = (const float*)fph; a.out = (float*)out;
  a.N = N; a.ns = ns; a.d_in = d_in; a.k_in = k_in; a.d_latent = d_latent;
  a.d_hidden = d_hidden; a.d_out = d_out; a.n_blocks = n_blocks; a.n_lin_z = n_lin_z;
  a.activate = activate;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(a, s) : launch<float>(a, s);
}
