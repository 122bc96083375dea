// K2: fused FC-ResNet field decoder: forward (optionally writing the
// activation stash) and the stash backward (a dgrad and a wgrad kernel).
//
// Replaces avr_tpu/ops/pallas/resnetfc.py:896 fused_resnetfc (forward
// kernel :726, stash outputs :637-653) and its stash backward
// _bwd_stash_impl (:400-575, call :823).  Per point: positional-encoding prologue from a per-column
// table; per source view lin_in + n_lin_z (latent injection + residual
// block); mean over views; remaining blocks; relu -> lin_out; optional
// sigmoid(rgb) / relu(sigma).  Trunk h in float32; matmul operands in T
// (bf16 or float32) with float32 accumulation.
//
// This forward serves float32 operands, and bf16 shapes outside the wgmma
// forward's envelope (csrc/resnetfc_hopper.cu resnetfc_fwd_wgmma_kernel:
// d_latent or the encoded input lanes above 512), as ops/kernels/resnetfc.py
// forward_route decides; its bf16 instantiation is also the in-run timing
// reference of that kernel.  Bound on H100: operations (~6.9 MFLOP per
// point; ~0.57 ms per 81,920-point band chunk at the bf16 tensor-core peak,
// against ~28 us of compulsory bytes).  Design (first version, simple): one
// CTA per TM = 32 points,
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
//
// Stash backward, float32 operands (the card's float32 parity runs; the
// bf16 backward is csrc/resnetfc_hopper.cu's, on wgmma and TMA).  The dgrad
// kernel walks a 32-point tile's chain in reverse with the forward's tiling
// (transposed weight copies as the B operand), reads each block's two
// stashed activations for the ReLU masks, writes every product's output
// cotangent (what the TPU kernel feeds its wgrad), and ends in dz and dx
// (the encoding's cos lanes summed back onto the raw lanes).  The wgrad
// kernel sums dW = G^T A over the points for every weight in one launch:
// 128 x 128 dW tiles, 8 warps of FMA, both operands copied K-major into
// shared memory by cp.async (two stages: the next rows load while the
// current ones multiply); at most 8 row chunks per tile meet in float32
// atomics; bias gradients are column sums of the cotangents.
//
// Recompute backward (replaces the TPU's _bwd_impl, :248-390, call :853,
// which stash="auto" takes above 6 GiB of stash): per chunk of points the
// host launches the stash forward into a chunk-sized workspace, the dgrad
// on it and the wgrad (ops/kernels/resnetfc.py _backward_recompute), so its
// results equal the stash backward's bit for bit by construction.

#include "resnetfc.cuh"

constexpr int TM = 32;  // points per CTA

// rows [0, TM) x [0, width) of a shared T tile -> global rows r0.. (row
// stride width), 16-byte copies, rows past N skipped.
template <typename T>
__device__ __forceinline__ void tile_to_global(const T* As, int lda, T* dst, int r0, int N,
                                               int width) {
  constexpr int V = Vec16<T>::N;
  const int nv = width / V;
  for (int idx = threadIdx.x; idx < TM * nv; idx += blockDim.x) {
    const int r = idx / nv, cv = idx - r * nv;
    if (r0 + r < N)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * width + cv * V) =
          *reinterpret_cast<const uint4*>(As + r * lda + cv * V);
  }
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// global rows r0.. (row stride width) -> shared tile, zeros past N.
template <typename T>
__device__ __forceinline__ void global_to_tile(const T* src, int r0, int N, int width, T* As,
                                               int lda) {
  constexpr int V = Vec16<T>::N;
  const int nv = width / V;
  for (int idx = threadIdx.x; idx < TM * nv; idx += blockDim.x) {
    const int r = idx / nv, cv = idx - r * nv;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N) val = reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * width)[cv];
    *reinterpret_cast<uint4*>(As + r * lda + cv * V) = val;
  }
}

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

// h = h + relu(relu(h) @ W0^T + b0) @ W1^T + b1; with st1 / st2 (stash
// slot bases) the two activations are also written out.
template <typename T>
__device__ __forceinline__ void res_block(T* As, int lda, const T* w0, const float* b0, const T* w1,
                          const float* b1, int dh, int col0, Frag& h, Frag& acc, T* st1, T* st2,
                          int r0, int N) {
  __syncthreads();  // every warp is done reading the operand tile
  store_relu<T>(As, lda, col0, h);
  __syncthreads();
  if (st1) tile_to_global(As, lda, st1, r0, N, dh);
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
  if (st2) tile_to_global(As, lda, st2, r0, N, dh);
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
__host__ __device__ inline size_t fwd_smem_bytes(int k_in, int dh, int dl, int ns) {
  return (size_t)TM * (row_stride<T>(k_in > dh ? k_in : dh) + row_stride<T>(dl)) * sizeof(T) +
         (ns > 1 ? (size_t)TM * dh * sizeof(float) : 0);
}

// The forward of the point tile starting at row r0.
template <typename T>
__device__ __forceinline__ void resnetfc_tile(const FcArgs& a, unsigned char* smem, int r0) {
  constexpr int V = Vec16<T>::N;
  const int dh = a.d_hidden, dl = a.d_latent;
  const int lda = row_stride<T>(max(a.k_in, dh)), ldz = row_stride<T>(dl);
  T* As = reinterpret_cast<T*>(smem);
  T* Zs = As + TM * lda;
  float* Hs = reinterpret_cast<float*>(Zs + TM * ldz);  // view sum, ns > 1 only
  const int tid = threadIdx.x, col0 = (tid >> 5) * 64;
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  T* stash = static_cast<T*>(a.stash);
  const size_t slot = (size_t)a.N * dh;
  auto st = [&](int k, int j, int v) -> T* {
    return stash ? stash + stash_slot(k, j, v, a.ns, a.n_lin_z) * slot : nullptr;
  };
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
                   w1 + (size_t)k * dh * dh, a.b1 + (size_t)k * dh, dh, col0, h, acc,
                   st(k, 0, v), st(k, 1, v), r0, a.N);
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
                 w1 + (size_t)k * dh * dh, a.b1 + (size_t)k * dh, dh, col0, h, acc,
                 st(k, 0, 0), st(k, 1, 0), r0, a.N);

  // epilogue: relu -> lin_out (d_out is small: one thread per output)
  __syncthreads();
  store_relu<T>(As, lda, col0, h);
  __syncthreads();
  if (stash)
    tile_to_global(As, lda, stash + (size_t)(stash_slots(a.ns, a.n_blocks, a.n_lin_z) - 1) * slot,
                   r0, a.N, dh);
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
__global__ void __launch_bounds__(256, 1) resnetfc_kernel(FcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  resnetfc_tile<T>(a, smem, blockIdx.x * TM);
}

template <typename T>
static int launch(const FcArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T>(a.k_in, a.d_hidden, a.d_latent, a.ns);
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
                            const void* tables, const void* fph, void* out, void* stash, int N,
                            int ns,
                            int d_in, int k_in, int d_latent, int d_hidden, int d_out,
                            int n_blocks, int n_lin_z, int activate, int dtype, void* stream) {
  FcArgs a;
  a.x = (const float*)x; a.z = z; a.wi = wi; a.bi = (const float*)bi;
  a.wz = wz; a.bz = (const float*)bz; a.w0 = w0; a.b0 = (const float*)b0;
  a.w1 = w1; a.b1 = (const float*)b1; a.wo = wo; a.bo = (const float*)bo;
  a.tables = (const int*)tables; a.fph = (const float*)fph; a.out = (float*)out;
  a.stash = stash; a.pool = nullptr;
  a.N = N; a.ns = ns; a.d_in = d_in; a.k_in = k_in; a.d_latent = d_latent;
  a.d_hidden = d_hidden; a.d_out = d_out; a.n_blocks = n_blocks; a.n_lin_z = n_lin_z;
  a.activate = activate;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(a, s) : launch<float>(a, s);
}

// ---------------------------------------------------------------------------
// backward, consuming the stash: a dgrad kernel walks each point tile's
// chain in reverse and writes every product's output cotangent; a wgrad
// kernel sums dW = G^T A over the points.
// ---------------------------------------------------------------------------

// v rounded to T into the shared operand tile at the fragment positions.
template <typename T>
__device__ __forceinline__ void store_frag(T* As, int lda, int col0, const Frag& v) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        As[frag_row(mt, i) * lda + frag_col(col0, nt, i)] = from_f<T>(v[mt][nt][i]);
}

// One residual block's backward: gh is the trunk cotangent entering the
// block; on return, the one leaving it.  Gs / Ms are the operand and mask
// tiles; cot0 / cot1 the block's cotangent slots, a1 / a2 its stash slots.
template <typename T>
__device__ __forceinline__ void res_block_bwd(T* Gs, T* Ms, int ld, const T* w0T, const T* w1T,
                                              const T* a1, const T* a2, T* cot0, T* cot1,
                                              int dh, int col0, int r0, int N, Frag& gh,
                                              Frag& acc) {
  __syncthreads();  // every warp is done with both tiles
  store_frag<T>(Gs, ld, col0, gh);
  global_to_tile(a2, r0, N, dh, Ms, ld);
  __syncthreads();
  tile_to_global(Gs, ld, cot1, r0, N, dh);
  gemm_tile(Gs, ld, w1T, dh, col0, acc);  // d relu(fc_0) = gh @ W1
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!(to_f(Ms[frag_row(mt, i) * ld + frag_col(col0, nt, i)]) > 0.f)) acc[mt][nt][i] = 0.f;
  __syncthreads();
  store_frag<T>(Gs, ld, col0, acc);
  global_to_tile(a1, r0, N, dh, Ms, ld);
  __syncthreads();
  tile_to_global(Gs, ld, cot0, r0, N, dh);
  gemm_tile(Gs, ld, w0T, dh, col0, acc);  // d relu(h) = gnet @ W0
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (to_f(Ms[frag_row(mt, i) * ld + frag_col(col0, nt, i)]) > 0.f)
          gh[mt][nt][i] += acc[mt][nt][i];
}

template <typename T>
__host__ __device__ inline size_t dgrad_smem_bytes(int dh, int dl, int k_in, int ns) {
  return 2 * (size_t)TM * row_stride<T>(dh) * sizeof(T) +
         sizeof(float) * ((size_t)TM * dl + (size_t)TM * k_in + TM * GOUT_W);
}

// The backward of point tile `tile` from the stash: the float32 dgrad
// kernel's body.
template <typename T>
__device__ __forceinline__ void resnetfc_dgrad_tile(const FcBwdArgs& a, unsigned char* smem,
                                                    int tile) {
  const int dh = a.d_hidden, dl = a.d_latent, nb = a.n_blocks, nlz = a.n_lin_z, ns = a.ns;
  const int ld = row_stride<T>(dh);
  T* Gs = reinterpret_cast<T*>(smem);
  T* Ms = Gs + TM * ld;
  float* Zs = reinterpret_cast<float*>(Ms + TM * ld);  // TM x dl: dz accumulator
  float* Es = Zs + TM * dl;                            // TM x k_in: d encoding
  float* gs = Es + TM * a.k_in;                        // TM x GOUT_W: rounded g
  float* Hs = ns > 1 ? a.pool + (size_t)tile * TM * dh : nullptr;  // pooled cotangent
  const int tid = threadIdx.x, nw = blockDim.x >> 5, col0 = (tid >> 5) * 64;
  const int r0 = tile * TM, N = a.N;
  const size_t slot = (size_t)N * dh;
  const T* stash = static_cast<const T*>(a.stash);
  T* cot = static_cast<T*>(a.cot);
  const T* w0T = static_cast<const T*>(a.w0T);
  const T* w1T = static_cast<const T*>(a.w1T);
  const T* wzT = static_cast<const T*>(a.wzT);
  const T* wo = static_cast<const T*>(a.wo);
  auto st = [&](int k, int j, int v) { return stash + stash_slot(k, j, v, ns, nlz) * slot; };
  auto ct = [&](int k, int j, int v) { return cot + stash_slot(k, j, v, ns, nlz) * slot; };
  Frag gh, acc;

  // epilogue and lin_out: g_epi = g * act'(out_pre), gh = mask(aout) * (g_epi @ Wo)
  global_to_tile(stash + (size_t)(stash_slots(ns, nb, nlz) - 1) * slot, r0, N, dh, Ms, ld);
  __syncthreads();
  for (int idx = tid; idx < TM * GOUT_W; idx += blockDim.x) {
    const int r = idx / GOUT_W, o = idx - r * GOUT_W, row = r0 + r;
    float gv = 0.f;
    if (row < N && o < a.d_out) {
      gv = a.g[(size_t)row * a.d_out + o];
      if (a.activate) {
        const T* arow = Ms + r * ld;
        const T* wrow = wo + (size_t)o * dh;
        float sum = 0.f;
        for (int k = 0; k < dh; ++k) sum = fmaf(to_f(arow[k]), to_f(wrow[k]), sum);
        const float pre = sum + a.bo[o];
        if (o < 3) {
          const float sg = sigmoidf_(pre);
          gv = gv * sg * (1.f - sg);
        } else if (!(pre > 0.f)) {
          gv = 0.f;
        }
      }
      gv = round_to<T>(gv);
    }
    gs[idx] = gv;
    if (row < N) static_cast<T*>(a.gout)[(size_t)row * GOUT_W + o] = from_f<T>(gv);
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = frag_row(mt, i), c = frag_col(col0, nt, i);
        float sum = 0.f;
        for (int o = 0; o < a.d_out; ++o)
          sum = fmaf(gs[r * GOUT_W + o], to_f(wo[(size_t)o * dh + c]), sum);
        gh[mt][nt][i] = to_f(Ms[r * ld + c]) > 0.f ? sum : 0.f;
      }

  // pooled-trunk blocks
  for (int k = nb - 1; k >= nlz; --k)
    res_block_bwd<T>(Gs, Ms, ld, w0T + (size_t)k * dh * dh, w1T + (size_t)k * dh * dh,
                     st(k, 0, 0), st(k, 1, 0), ct(k, 0, 0), ct(k, 1, 0), dh, col0, r0, N, gh,
                     acc);
  if (ns > 1) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Hs[frag_row(mt, i) * dh + frag_col(col0, nt, i)] = gh[mt][nt][i];
  }
  const float inv_ns = 1.f / (float)ns;
  for (int v = 0; v < ns; ++v) {
    __syncthreads();  // the previous view is done with Zs and Es
    if (ns > 1) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            gh[mt][nt][i] = Hs[frag_row(mt, i) * dh + frag_col(col0, nt, i)] * inv_ns;
    }
    for (int i = tid; i < TM * dl; i += blockDim.x) Zs[i] = 0.f;
    for (int k = nlz - 1; k >= 0; --k) {
      res_block_bwd<T>(Gs, Ms, ld, w0T + (size_t)k * dh * dh, w1T + (size_t)k * dh * dh,
                       st(k, 0, v), st(k, 1, v), ct(k, 0, v), ct(k, 1, v), dh, col0, r0, N, gh,
                       acc);
      // injection k: dz += gh @ Wz_k (the trunk cotangent passes unchanged)
      __syncthreads();
      store_frag<T>(Gs, ld, col0, gh);
      __syncthreads();
      if (k == 0) tile_to_global(Gs, ld, cot + cot_in_slot(v, ns, nb, nlz) * slot, r0, N, dh);
      for (int cb = col0; cb < dl; cb += nw * 64) {
        gemm_tile(Gs, ld, wzT + ((size_t)k * dl + cb - col0) * dh, dh, col0, acc);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              Zs[frag_row(mt, i) * dl + frag_col(cb, nt, i)] += acc[mt][nt][i];
      }
    }
    // lin_in: d encoding = gh @ Wi (Gs holds the rounded cotangent)
    for (int cb = col0; cb < a.k_in; cb += nw * 64) {
      gemm_tile(Gs, ld, static_cast<const T*>(a.wiT) + (size_t)(cb - col0) * dh, dh, col0, acc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            Es[frag_row(mt, i) * a.k_in + frag_col(cb, nt, i)] = acc[mt][nt][i];
    }
    __syncthreads();
    // dx through the encoding: sin lanes carry cos(t) * f, raw lanes 1
    for (int idx = tid; idx < TM * a.d_in; idx += blockDim.x) {
      const int r = idx / a.d_in, lane = idx - r * a.d_in, row = r0 + r;
      if (row >= N) continue;
      const float p = a.x[((size_t)v * N + row) * a.d_in + lane];
      float sum = 0.f;
      for (int j = 0; j < a.k_in; ++j) {
        const int mode = a.tables[j];
        if (mode == 2 || a.tables[a.k_in + j] != lane) continue;
        float d = Es[r * a.k_in + j];
        if (mode == 1) d = d * (cosf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[a.k_in + j])) *
                                a.fph[j]);
        sum += d;
      }
      a.dx[((size_t)v * N + row) * a.d_in + lane] = sum;
    }
    // the encoded input (lin_in's operand for the wgrad) and dz
    T* enc = static_cast<T*>(a.enc) + (size_t)v * N * a.k_in;
    for (int idx = tid; idx < TM * a.k_in; idx += blockDim.x) {
      const int r = idx / a.k_in, j = idx - r * a.k_in, row = r0 + r;
      if (row >= N) continue;
      const int mode = a.tables[j];
      float val = 0.f;
      if (mode != 2) {
        const float p = a.x[((size_t)v * N + row) * a.d_in + a.tables[a.k_in + j]];
        val = mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[a.k_in + j]));
      }
      enc[(size_t)row * a.k_in + j] = from_f<T>(val);
    }
    T* dz = static_cast<T*>(a.dz) + (size_t)v * N * dl;
    for (int idx = tid; idx < TM * dl; idx += blockDim.x) {
      const int r = idx / dl, c = idx - r * dl, row = r0 + r;
      if (row < N) dz[(size_t)row * dl + c] = from_f<T>(Zs[idx]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256, 1) resnetfc_dgrad_kernel(FcBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  resnetfc_dgrad_tile<T>(a, smem, blockIdx.x);
}

template <typename T>
static int launch_dgrad(const FcBwdArgs& a, cudaStream_t stream) {
  const size_t smem = dgrad_smem_bytes<T>(a.d_hidden, a.d_latent, a.k_in, a.ns);
  cudaError_t e = cudaFuncSetAttribute(resnetfc_dgrad_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((a.N + TM - 1) / TM);
  resnetfc_dgrad_kernel<T><<<blocks, a.d_hidden / 64 * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int avr_resnetfc_dgrad(const void* x, const void* g, const void* stash,
                                  const void* wiT, const void* wzT, const void* w0T,
                                  const void* w1T, const void* wo, const void* bo,
                                  const void* tables, const void* fph, void* dx, void* dz,
                                  void* cot, void* gout, void* enc, void* pool, int N, int ns,
                                  int d_in,
                                  int k_in, int d_latent, int d_hidden, int d_out, int n_blocks,
                                  int n_lin_z, int activate, int dtype, void* stream) {
  FcBwdArgs a;
  a.x = (const float*)x; a.g = (const float*)g; a.stash = stash; a.wiT = wiT; a.wzT = wzT;
  a.w0T = w0T; a.w1T = w1T; a.wo = wo; a.bo = (const float*)bo; a.tables = (const int*)tables;
  a.fph = (const float*)fph; a.dx = (float*)dx; a.dz = dz; a.cot = cot; a.gout = gout;
  a.enc = enc; a.pool = (float*)pool; a.N = N; a.ns = ns; a.d_in = d_in; a.k_in = k_in; a.d_latent = d_latent;
  a.d_hidden = d_hidden; a.d_out = d_out; a.n_blocks = n_blocks; a.n_lin_z = n_lin_z;
  a.activate = activate;
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // bf16: csrc/resnetfc_hopper.cu
  return launch_dgrad<float>(a, (cudaStream_t)stream);
}

// dW (Mg x Ka) += G^T A and db (Mg) += column sums of G over the rows of
// one job: G (rows x ldg) and A (rows x lda) in T.
struct WgradJob {
  const void* G;
  const void* A;
  float* dW;
  float* db;  // nullptr: no bias
  int rows, ldg, lda, Mg, Ka, chunk, tiles_o, tiles_i, first_block;
};

constexpr int MAX_JOBS = 24;
constexpr int WT = 128;  // dW tile edge
constexpr int KC = 32;   // rows per shared-memory step (bf16; float32 takes 16)
template <typename T> __host__ __device__ constexpr int kc() { return sizeof(T) == 2 ? KC : 16; }

struct WgradArgs {
  WgradJob job[MAX_JOBS];
  int n_jobs;
};

// Row stride of the shared tiles (rows of WT values): 16-byte rows whose
// 16-byte ldmatrix reads from 8 consecutive rows hit distinct banks.
template <typename T> __host__ __device__ constexpr int wt_stride() {
  return sizeof(T) == 2 ? WT + 8 : WT + 4;
}

// rows [n0, n0 + kc) x cols [c0, c0 + WT) of X (row stride ldx; rows <
// rows and cols < ncols are valid) -> shared Xs[n - n0][c - c0], zeros
// outside.  Whole valid 16-byte vectors go by cp.async (the caller commits
// and waits); the rest is stored directly.
template <typename T>
__device__ __forceinline__ void load_tile_async(const T* X, int ldx, int rows, int ncols,
                                                int n0, int c0, T* Xs) {
  constexpr int V = Vec16<T>::N, L = wt_stride<T>();
  for (int idx = threadIdx.x; idx < kc<T>() * (WT / V); idx += blockDim.x) {
    const int n = idx / (WT / V), cv = idx - n * (WT / V), c = c0 + cv * V;
    T* dst = Xs + n * L + cv * V;
    const bool live = n0 + n < rows && c < ldx;
    if (live && c + V <= ncols) {
      cp_async16(dst, X + (size_t)(n0 + n) * ldx + c);
      continue;
    }
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (live) {  // a partly valid vector: zero the columns past ncols
      val = __ldg(reinterpret_cast<const uint4*>(X + (size_t)(n0 + n) * ldx + c));
      T* e = reinterpret_cast<T*>(&val);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c + j >= ncols) e[j] = from_f<T>(0.f);
    }
    *reinterpret_cast<uint4*>(dst) = val;
  }
}


__device__ __forceinline__ void wgrad_step(const float* Gs, const float* As, int m0, int n0,
                                           Frag& acc) {
  constexpr int L = WT + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < kc<float>(); ++k)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float gv = Gs[k * L + m0 + mt * 16 + g + 8 * hi];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            acc[mt][nt][2 * hi + cc] = fmaf(gv, As[k * L + n0 + nt * 8 + 2 * t + cc],
                                            acc[mt][nt][2 * hi + cc]);
      }
}

template <typename T>
__global__ void __launch_bounds__(256) resnetfc_wgrad_kernel(WgradArgs args) {
  constexpr int L = wt_stride<T>(), K = kc<T>();
  __shared__ __align__(16) T Gs[2][K * L];  // two stages: the next rows load while
  __shared__ __align__(16) T As[2][K * L];  // the current ones multiply
  int j = 0;
  while (j + 1 < args.n_jobs && (int)blockIdx.x >= args.job[j + 1].first_block) ++j;
  const WgradJob& job = args.job[j];
  const int local = blockIdx.x - job.first_block;
  const int tiles = job.tiles_o * job.tiles_i;
  const int tile = local % tiles, chunk = local / tiles;
  const int o0 = (tile / job.tiles_i) * WT, i0 = (tile % job.tiles_i) * WT;
  const int r_begin = chunk * job.chunk;
  const int r_end = min(job.rows, r_begin + job.chunk);
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 32, n0 = (warp >> 2) * 64;
  const bool bias = job.db != nullptr && i0 == 0;
  const T* G = static_cast<const T*>(job.G);
  const T* A = static_cast<const T*>(job.A);
  Frag acc;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  float bsum = 0.f;
  int stage = 0;
  load_tile_async(G, job.ldg, r_end, job.Mg, r_begin, o0, Gs[0]);
  load_tile_async(A, job.lda, r_end, job.Ka, r_begin, i0, As[0]);
  cp_async_commit();
  for (int r = r_begin; r < r_end; r += K) {
    if (r + K < r_end) {  // prefetch the next rows into the other stage
      load_tile_async(G, job.ldg, r_end, job.Mg, r + K, o0, Gs[stage ^ 1]);
      load_tile_async(A, job.lda, r_end, job.Ka, r + K, i0, As[stage ^ 1]);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's rows have landed for every thread
    if (bias && threadIdx.x < WT)
      for (int k = 0; k < K; ++k) bsum += to_f(Gs[stage][k * L + threadIdx.x]);
    wgrad_step(Gs[stage], As[stage], m0, n0, acc);
    __syncthreads();  // done with this stage before it is refilled
    stage ^= 1;
  }
  if (bias && threadIdx.x < WT && o0 + (int)threadIdx.x < job.Mg)
    atomicAdd(job.db + o0 + threadIdx.x, bsum);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = o0 + m0 + frag_row(mt, i), c = i0 + frag_col(n0, nt, i);
        if (o < job.Mg && c < job.Ka) atomicAdd(job.dW + (size_t)o * job.Ka + c, acc[mt][nt][i]);
      }
}

extern "C" int avr_resnetfc_wgrad(const void* const* G, const void* const* A, void* const* dW,
                                  void* const* db, const int* dims, int n_jobs, int dtype,
                                  void* stream) {
  // dims: per job (rows, ldg, lda, Mg, Ka)
  if (n_jobs > MAX_JOBS || n_jobs < 1) return (int)cudaErrorInvalidValue;
  WgradArgs args;
  int blocks = 0;
  for (int j = 0; j < n_jobs; ++j) {
    WgradJob& w = args.job[j];
    w.G = G[j]; w.A = A[j]; w.dW = (float*)dW[j]; w.db = (float*)db[j];
    w.rows = dims[5 * j]; w.ldg = dims[5 * j + 1]; w.lda = dims[5 * j + 2];
    w.Mg = dims[5 * j + 3]; w.Ka = dims[5 * j + 4];
    // at most 8 row chunks per tile: bounds the float32 atomics to 8 per dW element
    const int chunk = max(4096, (w.rows + 7) / 8);
    w.chunk = (chunk + KC - 1) / KC * KC;  // a multiple of both row steps
    w.tiles_o = (w.Mg + WT - 1) / WT;
    w.tiles_i = (w.Ka + WT - 1) / WT;
    w.first_block = blocks;
    blocks += w.tiles_o * w.tiles_i * ((w.rows + w.chunk - 1) / w.chunk);
  }
  args.n_jobs = n_jobs;
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // bf16: csrc/resnetfc_hopper.cu
  resnetfc_wgrad_kernel<float><<<blocks, 256, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
