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
// Two forward kernels.  resnetfc_kernel<bf16> serves bf16 shapes outside
// the wgmma forward's envelope (csrc/resnetfc_hopper.cu
// resnetfc_fwd_wgmma_kernel: d_latent or the encoded input lanes above
// 512), as ops/kernels/resnetfc.py forward_route decides; it is also the
// in-run timing reference of that kernel.  Bound on H100: operations (~6.9
// MFLOP per point; ~0.57 ms per 81,920-point band chunk at the bf16
// tensor-core peak, against ~28 us of compulsory bytes).  Design (first
// version, simple): one CTA per TM = 32 points, d_hidden / 64 warps, each
// warp owning 64 output columns of every product.  The trunk lives in
// registers in the mma accumulator layout; the current operand tile
// (encoding, activation) and the latent tile live in shared memory, so no
// (N, 512) activation reaches device memory.  Weights (~6.8 MB in bf16,
// more than shared memory holds) are read from L2 with 16-byte loads in
// nn.Linear (out, in) layout, which is exactly the column-major B fragment
// of mma.sync.m16n8k16.  float32 operands take resnetfc_fwd_f32_kernel
// (below): register-tiled FMA products with every weight slab staged in
// shared memory by bulk copies.
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
// kernel walks a 32-point tile's chain in reverse with the bf16 forward's
// tiling and a plain FMA loop in its fragment ownership (transposed weight
// copies as the B operand), reads each block's two stashed activations for
// the ReLU masks, writes every product's output cotangent (what the TPU
// kernel feeds its wgrad), and ends in dz and dx (the encoding's cos lanes
// summed back onto the raw lanes).  The wgrad kernel
// (resnetfc_wgrad_f32_kernel) sums dW = G^T A over the points for every
// weight in one launch: 128 x 128 dW tiles, 8 x 8 outputs a thread read
// from K-major shared tiles by 16-byte loads (4 for 64 FMAs, the next row's
// read while the current one multiplies), both operands copied by cp.async
// into a 3-stage ring of 32-row stages (two CTAs an SM); narrow modes keep
// a skinny tile's threads on its valid outputs; the rows split so that each job
// gets at least WGRAD_WAVES_F32 waves of CTAs on the card where its rows
// allow WGRAD_MIN_CHUNK_F32 a split (ops/kernels/resnetfc.py wgrad_plan).
// No float atomics: each (split, tile) CTA writes its float32 partial tile,
// and its share of the bias gradients (column sums of the cotangents; the
// row range's column tiles take turns by stage), to a partials buffer, and
// the bf16 wgrad's reduction (csrc/resnetfc_hopper.cu
// resnetfc_wgrad_reduce_kernel) adds the splits in split order into dW and
// db: the same bits on every run.  Bound on H100: operations (~2.2 TFLOP
// at K2's 15 jobs of 327,680 points: 33.6 ms at 67 TFLOP/s); the partials
// are 4 bytes a dW element and split, written once and read once.
//
// Recompute backward (replaces the TPU's _bwd_impl, :248-390, call :853,
// which stash="auto" takes above 6 GiB of stash): per chunk of points the
// host launches the stash forward into a chunk-sized workspace, the dgrad
// on it and the wgrad (ops/kernels/resnetfc.py _backward_recompute), so its
// results equal the stash backward's bit for bit by construction.

#include "hopper.cuh"
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

static int launch_bf16(const FcArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<bf16>(a.k_in, a.d_hidden, a.d_latent, a.ns);
  cudaError_t e = cudaFuncSetAttribute(resnetfc_kernel<bf16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((a.N + TM - 1) / TM);
  resnetfc_kernel<bf16><<<blocks, a.d_hidden / 64 * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16 operands only (float32 takes avr_resnetfc_fwd_f32 below).
extern "C" int avr_resnetfc(const void* x, const void* z, const void* wi, const void* bi,
                            const void* wz, const void* bz, const void* w0, const void* b0,
                            const void* w1, const void* b1, const void* wo, const void* bo,
                            const void* tables, const void* fph, void* out, void* stash, int N,
                            int ns,
                            int d_in, int k_in, int d_latent, int d_hidden, int d_out,
                            int n_blocks, int n_lin_z, int activate, int dtype, void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  FcArgs a;
  a.x = (const float*)x; a.z = z; a.wi = wi; a.bi = (const float*)bi;
  a.wz = wz; a.bz = (const float*)bz; a.w0 = w0; a.b0 = (const float*)b0;
  a.w1 = w1; a.b1 = (const float*)b1; a.wo = wo; a.bo = (const float*)bo;
  a.tables = (const int*)tables; a.fph = (const float*)fph; a.out = (float*)out;
  a.stash = stash; a.pool = nullptr;
  a.N = N; a.ns = ns; a.d_in = d_in; a.k_in = k_in; a.d_latent = d_latent;
  a.d_hidden = d_hidden; a.d_out = d_out; a.n_blocks = n_blocks; a.n_lin_z = n_lin_z;
  a.activate = activate;
  return launch_bf16(a, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// float32 forward (resnetfc_fwd_f32_kernel): register-tiled FMA products,
// every weight k-slab staged into shared memory by bulk copies.
//
// A CTA takes F32_TM = 32 points.  Its d_hidden / 2 threads (d_hidden /
// 64 warps) each own 8 points x 8 columns of every product: points tp + 4
// i (tp = lane / 8, i < 8), columns c0 = 4 tc + {0..3} and c1 = d_hidden /
// 2 + 4 tc + {0..3} (tc = 8 warp + lane % 8).  The trunk h and the
// product's accumulators stay in registers (64 + 64 a thread: eight warps
// an SM leave up to 255 registers a thread, where a ninth, producer warp
// would cap every thread at 168 and spill); the product's A operand (the
// encoding, or the activation relu(.)) is a shared tile of 32 rows of
// d_hidden + 4 floats, read along k by 16-byte loads (a warp's 4 point rows
// hit 4 distinct bank groups).  The weights go transposed (k rows of
// d_hidden columns; ops/kernels/resnetfc.py prepares the copies), so a
// slab of F32_KS k rows is one contiguous block.  The tile's whole
// sequence of slabs (per view lin_in, then each injection's latent product
// and its block's two products; then the pooled blocks) streams through a
// ring of F32_STAGES stages, one mbarrier a stage for its arrival and one
// for its release by the warps: the warps take turns to issue a slab
// F32_AHEAD ahead of the one being multiplied (a bulk copy of its weight
// rows and, for a latent product, one of each of its points' z rows, all
// completing on the stage's barrier), into the stage all warps released two
// slabs ago, so the next slabs are in flight while the current one is
// multiplied.  Per k a thread does 64
// FMAs for two 16-byte weight loads (a warp's 8 column groups: 128
// contiguous bytes) and, per four k, eight 16-byte point-row loads.  Each
// output is one FMA chain in k order, float32 throughout (no tensor cores,
// no TF32).  The view sum of NS > 1 goes to pool (each thread its own 64
// values, coalesced) and is scaled by 1 / NS after the last view, in JAX's
// order.  Bound on H100: operations (6.86 MFLOP a point; 8.39 ms at 81,920
// points at 67 TFLOP/s); every CTA reads the ~13.8 MB of weights once
// through L2 (1.7 ms at the band by bulk copies alone: f32_turns.py
// --probe).
// ---------------------------------------------------------------------------

constexpr int F32_TM = 32;             // points a CTA
constexpr int F32_KS = 16;             // k rows a slab
constexpr int F32_STAGES = 4;          // stages of the weight ring
constexpr int F32_ZLD = F32_KS + 4;    // row stride (floats) of a stage's latent rows
constexpr int F32_AHEAD = F32_STAGES - 2;  // slabs issued ahead of the one being multiplied
constexpr int F32_Z = F32_TM * F32_ZLD;

// shared memory: the ring (each stage a slab of d_hidden columns and its
// latent rows), the A tile, the barriers
__host__ __device__ inline int f32_stage_floats(int dh) { return F32_KS * dh + F32_Z; }
__host__ __device__ inline size_t f32_fwd_smem_bytes(int dh) {
  return 4 * ((size_t)F32_STAGES * f32_stage_floats(dh) + (size_t)F32_TM * (dh + 4)) +
         16 * F32_STAGES;
}

// The tile's weight slabs in stream order: per view lin_in's k_in / F32_KS
// slabs, then per injection k its latent product's d_latent / F32_KS slabs
// (each with the points' z rows) and its block's two products' d_hidden /
// F32_KS each; then the pooled blocks' two products.  Each warp keeps a
// cursor over them; the warps take turns to issue the slabs, each F32_AHEAD
// ahead of the one being multiplied.
struct F32Cursor {
  int v, k, seg, k0;  // view, block, product (0 lin_in, 1 latent, 2 fc_0, 3 fc_1), first row
};

struct F32Pipe {
  float* base;       // stage s at base + s * stage
  int stage;         // floats a stage
  uint64_t* full;    // arrival of a stage's slab
  uint64_t* empty;   // its release by every consumer warp
  int i;             // the next slab to multiply
  int total;         // slabs of the tile
  int r0;            // the tile's first point
  int warps;         // the CTA's warps: slab j is issued by warp j % warps
  F32Cursor next;    // the next slab to issue
};

__device__ __forceinline__ int f32_slabs(const FcArgs& a) {
  return (a.ns * (a.k_in + a.n_lin_z * (a.d_latent + 2 * a.d_hidden)) +
          (a.n_blocks - a.n_lin_z) * 2 * a.d_hidden) / F32_KS;
}

// Slab j (the cursor's) into its stage, by its warp (mine: j's turn among
// the warps) once every warp has released the stage's previous slab (j -
// F32_STAGES): the weight rows by one bulk copy, a latent slab's z rows (the
// tile's points below N) by one each, all completing on the stage's full
// barrier.  Every warp advances its cursor.
__device__ __forceinline__ void f32_issue(const FcArgs& a, F32Pipe& p, int j, bool mine) {
  const int lane = threadIdx.x & 31, dh = a.d_hidden, dl = a.d_latent, st = j % F32_STAGES;
  F32Cursor& c = p.next;
  int rows;  // k rows of the cursor's product
  switch (c.seg) {
    case 0: rows = a.k_in; break;
    case 1: rows = dl; break;
    default: rows = dh; break;
  }
  if (mine) {
    if (j >= F32_STAGES) mbar_wait(&p.empty[st], (uint32_t)(j / F32_STAGES - 1) & 1u);
    const size_t sq = (size_t)dh * dh;
    const float* w;
    switch (c.seg) {
      case 0: w = static_cast<const float*>(a.wi); break;
      case 1: w = static_cast<const float*>(a.wz) + (size_t)c.k * dl * dh; break;
      case 2: w = static_cast<const float*>(a.w0) + c.k * sq; break;
      default: w = static_cast<const float*>(a.w1) + c.k * sq; break;
    }
    float* dst = p.base + (size_t)st * p.stage;
    const int live = c.seg == 1 ? min(F32_TM, a.N - p.r0) : 0;
    const uint32_t wbytes = (uint32_t)(F32_KS * dh * 4);
    if (lane == 0) mbar_expect_tx(&p.full[st], wbytes + (uint32_t)(live * F32_KS * 4));
    __syncwarp();
    if (lane == 0) bulk_load(dst, w + (size_t)c.k0 * dh, wbytes, &p.full[st]);
    if (lane < live)
      bulk_load(dst + F32_KS * dh + lane * F32_ZLD,
                static_cast<const float*>(a.z) + ((size_t)c.v * a.N + p.r0 + lane) * dl + c.k0,
                F32_KS * 4, &p.full[st]);
  }
  c.k0 += F32_KS;
  if (c.k0 < rows) return;
  c.k0 = 0;  // the next product
  if (c.seg == 0) {
    c.seg = 1;
  } else if (c.seg < 3) {
    ++c.seg;
  } else if (++c.k < a.n_lin_z) {
    c.seg = 1;  // the view's next injection
  } else if (c.k == a.n_lin_z && c.v + 1 < a.ns) {
    ++c.v;  // the next view
    c.k = 0;
    c.seg = 0;
  } else {
    c.seg = 2;  // a pooled block
  }
}

// acc (+)= A (32 points x 16 k) W (16 x dh) for this thread's 8 x 8 outputs;
// A rows lda floats apart, W rows dh floats apart.
__device__ __forceinline__ void f32_fma_slab(const float* A, int lda, const float* W, int dh,
                                             int tp, int c0, int c1, float (&acc)[8][8]) {
#pragma unroll
  for (int k4 = 0; k4 < F32_KS; k4 += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (tp + 4 * i) * lda + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(W + (k4 + kk) * dh + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(W + (k4 + kk) * dh + c1);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
}

// Consume the next n slabs of the pipe into acc: A from the shared tile As
// (its columns from 0 on for the slabs' k) or, As == nullptr, from the
// stages' latent rows.  The slab F32_AHEAD ahead is issued first, by its
// warp.
__device__ __forceinline__ void f32_product(const FcArgs& a, F32Pipe& p, int n, const float* As,
                                            int lda, int tp, int c0, int c1,
                                            float (&acc)[8][8]) {
  const int dh = a.d_hidden;
  for (int s = 0; s < n; ++s, ++p.i) {
    const int j = p.i + F32_AHEAD;
    if (j < p.total) f32_issue(a, p, j, j % p.warps == (int)(threadIdx.x >> 5));
    const int st = p.i % F32_STAGES;
    mbar_wait(&p.full[st], (uint32_t)(p.i / F32_STAGES) & 1u);
    const float* W = p.base + (size_t)st * p.stage;
    f32_fma_slab(As ? As + s * F32_KS : W + F32_KS * dh, As ? lda : F32_ZLD, W, dh, tp, c0, c1,
                 acc);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&p.empty[st]);
  }
}

__device__ __forceinline__ void f32_zero(float (&v)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
}

// relu(v) into the A tile at this thread's points and columns
__device__ __forceinline__ void f32_store_relu(float* As, int lda, int tp, int c0, int c1,
                                               const float (&v)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = As + (tp + 4 * i) * lda;
    *reinterpret_cast<float4*>(row + c0) =
        make_float4(fmaxf(v[i][0], 0.f), fmaxf(v[i][1], 0.f), fmaxf(v[i][2], 0.f),
                    fmaxf(v[i][3], 0.f));
    *reinterpret_cast<float4*>(row + c1) =
        make_float4(fmaxf(v[i][4], 0.f), fmaxf(v[i][5], 0.f), fmaxf(v[i][6], 0.f),
                    fmaxf(v[i][7], 0.f));
  }
}

// the bias of this thread's 8 columns
__device__ __forceinline__ void f32_bias(const float* b, int c0, int c1, float (&bv)[8]) {
  const float4 p = __ldg(reinterpret_cast<const float4*>(b + c0));
  const float4 q = __ldg(reinterpret_cast<const float4*>(b + c1));
  bv[0] = p.x; bv[1] = p.y; bv[2] = p.z; bv[3] = p.w;
  bv[4] = q.x; bv[5] = q.y; bv[6] = q.z; bv[7] = q.w;
}

// the A tile's rows (width dh) -> stash slot rows r0.., rows past N skipped,
// by the nc consumer threads
__device__ __forceinline__ void f32_tile_to_global(const float* As, int lda, float* dst, int r0,
                                                   int N, int dh, int tid, int nc) {
  const int nv = dh / 4;
  for (int idx = tid; idx < F32_TM * nv; idx += nc) {
    const int r = idx / nv, cv = idx - r * nv;
    if (r0 + r < N)
      *reinterpret_cast<float4*>(dst + (size_t)(r0 + r) * dh + cv * 4) =
          *reinterpret_cast<const float4*>(As + r * lda + cv * 4);
  }
}

// h = h + relu(relu(h) @ W0 + b0) @ W1 + b1 (the block's two products'
// slabs next in the pipe); st1 / st2: the stash slots of relu(h) and
// relu(fc_0), or nullptr.
__device__ __forceinline__ void f32_res_block(const FcArgs& a, F32Pipe& p, float* As, int lda,
                                              int tp, int c0, int c1, const float* b0,
                                              const float* b1, float* st1, float* st2,
                                              float (&h)[8][8], float (&acc)[8][8]) {
  const int tid = threadIdx.x, nc = blockDim.x, dh = a.d_hidden;
  float bv[8];
  named_sync(1, nc);  // every thread is done reading the A tile
  f32_store_relu(As, lda, tp, c0, c1, h);
  named_sync(1, nc);
  f32_zero(acc);
  f32_product(a, p, dh / F32_KS, As, lda, tp, c0, c1, acc);
  if (st1) f32_tile_to_global(As, lda, st1, p.r0, a.N, dh, tid, nc);
  f32_bias(b0, c0, c1, bv);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = acc[i][j] + bv[j];
  named_sync(1, nc);
  f32_store_relu(As, lda, tp, c0, c1, acc);
  named_sync(1, nc);
  f32_zero(acc);
  f32_product(a, p, dh / F32_KS, As, lda, tp, c0, c1, acc);
  if (st2) f32_tile_to_global(As, lda, st2, p.r0, a.N, dh, tid, nc);
  f32_bias(b1, c0, c1, bv);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) h[i][j] = (h[i][j] + acc[i][j]) + bv[j];
}

// a.wi, wz, w0, w1: the weights transposed, (k_in, dh), (n_lin_z, dl, dh)
// and (n_blocks, dh, dh) twice; a.pool: NS > 1, 32 x dh floats a tile.
// d_hidden / 2 threads (at 512, eight warps: one CTA an SM, up to 255
// registers a thread).
__global__ void __launch_bounds__(256, 1)
resnetfc_fwd_f32_kernel(const __grid_constant__ FcArgs a) {
  extern __shared__ __align__(128) float f32_smem[];
  // nc = d_hidden / 2 (the launch's), read from blockDim: derived from
  // d_hidden, it costs the kernel ~400 bytes of spills
  const int dh = a.d_hidden, nc = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  F32Pipe p;
  p.stage = f32_stage_floats(dh);
  p.base = f32_smem;
  float* As = f32_smem + (size_t)F32_STAGES * p.stage;
  const int lda = dh + 4;
  p.full = reinterpret_cast<uint64_t*>(As + F32_TM * lda);
  p.empty = p.full + F32_STAGES;
  p.i = 0;
  p.total = f32_slabs(a);
  p.r0 = blockIdx.x * F32_TM;
  p.next = F32Cursor{0, 0, 0, 0};
  p.warps = nc / 32;
  if (tid == 0) {
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(&p.full[s], 1);
      mbar_init(&p.empty[s], nc / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  for (int j = 0; j < F32_AHEAD && j < p.total; ++j) f32_issue(a, p, j, j % p.warps == warp);
  const int tp = lane >> 3, tc = warp * 8 + (lane & 7), c0 = 4 * tc, c1 = nc + 4 * tc;
  const int r0 = p.r0;
  const size_t slot = (size_t)a.N * dh;
  float* stash = static_cast<float*>(a.stash);
  auto st = [&](int k, int j, int v) -> float* {
    return stash ? stash + stash_slot(k, j, v, a.ns, a.n_lin_z) * slot : nullptr;
  };
  float h[8][8], acc[8][8], bv[8];
  // the view sum (NS > 1): this thread's 64 values, coalesced over the threads
  float* pool = a.pool + (size_t)blockIdx.x * 64 * nc + tid;

  for (int v = 0; v < a.ns; ++v) {
    // lin_in, over the encoded lanes in chunks of at most dh columns of the A tile
    f32_zero(acc);
    for (int j0 = 0; j0 < a.k_in; j0 += dh) {
      const int w = min(dh, a.k_in - j0);
      named_sync(1, nc);  // every thread is done reading the A tile
      for (int idx = tid; idx < F32_TM * w; idx += nc) {
        const int r = idx / w, jj = idx - r * w, j = j0 + jj, row = r0 + r;
        const int mode = a.tables[j];
        float val = 0.f;
        if (row < a.N && mode != 2) {
          const float x = a.x[((size_t)v * a.N + row) * a.d_in + a.tables[a.k_in + j]];
          val = mode == 0 ? x : sinf(__fadd_rn(__fmul_rn(x, a.fph[j]), a.fph[a.k_in + j]));
        }
        As[r * lda + jj] = val;
      }
      named_sync(1, nc);
      f32_product(a, p, w / F32_KS, As, lda, tp, c0, c1, acc);
    }
    f32_bias(a.bi, c0, c1, bv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) h[i][j] = acc[i][j] + bv[j];
    for (int k = 0; k < a.n_lin_z; ++k) {
      f32_zero(acc);
      f32_product(a, p, a.d_latent / F32_KS, nullptr, 0, tp, c0, c1, acc);
      f32_bias(a.bz + (size_t)k * dh, c0, c1, bv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) h[i][j] = (h[i][j] + acc[i][j]) + bv[j];
      f32_res_block(a, p, As, lda, tp, c0, c1, a.b0 + (size_t)k * dh, a.b1 + (size_t)k * dh,
                    st(k, 0, v), st(k, 1, v), h, acc);
    }
    if (a.ns > 1) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        float& s = pool[(size_t)e * nc];
        s = v == 0 ? h[e >> 3][e & 7] : s + h[e >> 3][e & 7];
      }
    }
  }
  if (a.ns > 1) {
    const float inv = 1.f / (float)a.ns;
#pragma unroll
    for (int e = 0; e < 64; ++e) h[e >> 3][e & 7] = pool[(size_t)e * nc] * inv;
  }
  for (int k = a.n_lin_z; k < a.n_blocks; ++k)
    f32_res_block(a, p, As, lda, tp, c0, c1, a.b0 + (size_t)k * dh, a.b1 + (size_t)k * dh,
                  st(k, 0, 0), st(k, 1, 0), h, acc);

  // epilogue: relu -> lin_out (d_out is small: one thread per output)
  named_sync(1, nc);
  f32_store_relu(As, lda, tp, c0, c1, h);
  named_sync(1, nc);
  if (stash)
    f32_tile_to_global(As, lda,
                       stash + (size_t)(stash_slots(a.ns, a.n_blocks, a.n_lin_z) - 1) * slot, r0,
                       a.N, dh, tid, nc);
  const float* wo = static_cast<const float*>(a.wo);
  for (int idx = tid; idx < F32_TM * a.d_out; idx += nc) {
    const int r = idx / a.d_out, o = idx - r * a.d_out, row = r0 + r;
    if (row >= a.N) continue;
    const float* arow = As + r * lda;
    const float* wrow = wo + (size_t)o * dh;
    float s = 0.f;
    for (int k = 0; k < dh; ++k) s = fmaf(arow[k], wrow[k], s);
    s = s + a.bo[o];
    if (a.activate) s = o < 3 ? sigmoidf_(s) : fmaxf(s, 0.f);
    a.out[(size_t)row * a.d_out + o] = s;
  }
}

extern "C" int avr_resnetfc_fwd_f32(const void* x, const void* z, const void* wiT, const void* bi,
                                    const void* wzT, const void* bz, const void* w0T,
                                    const void* b0, const void* w1T, const void* b1,
                                    const void* wo, const void* bo, const void* tables,
                                    const void* fph, void* out, void* stash, void* pool, int N,
                                    int ns, int d_in, int k_in, int d_latent, int d_hidden,
                                    int d_out, int n_blocks, int n_lin_z, int activate,
                                    void* stream) {
  if (N < 1 || ns < 1 || d_hidden % 64 || d_hidden < 64 || d_hidden > 512 || d_latent % 64 ||
      d_latent < 64 || k_in % 64 || k_in < 64 || d_out > GOUT_W || n_lin_z < 1 ||
      n_lin_z > n_blocks || (ns > 1 && !pool) || ((uintptr_t)z & 15) || ((uintptr_t)wiT & 15) ||
      ((uintptr_t)wzT & 15) || ((uintptr_t)w0T & 15) || ((uintptr_t)w1T & 15))
    return (int)cudaErrorInvalidValue;
  FcArgs a;
  a.x = (const float*)x; a.z = z; a.wi = wiT; a.bi = (const float*)bi;
  a.wz = wzT; a.bz = (const float*)bz; a.w0 = w0T; a.b0 = (const float*)b0;
  a.w1 = w1T; a.b1 = (const float*)b1; a.wo = wo; a.bo = (const float*)bo;
  a.tables = (const int*)tables; a.fph = (const float*)fph; a.out = (float*)out;
  a.stash = stash; a.pool = (float*)pool;
  a.N = N; a.ns = ns; a.d_in = d_in; a.k_in = k_in; a.d_latent = d_latent;
  a.d_hidden = d_hidden; a.d_out = d_out; a.n_blocks = n_blocks; a.n_lin_z = n_lin_z;
  a.activate = activate;
  const size_t smem = f32_fwd_smem_bytes(d_hidden);
  cudaError_t e = cudaFuncSetAttribute(resnetfc_fwd_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((N + F32_TM - 1) / F32_TM);
  resnetfc_fwd_f32_kernel<<<blocks, d_hidden / 2, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
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
// one job: G (rows x ldg) and A (rows x lda), float32.  The partial tiles
// and bias sums of its (split, tile) CTAs go to part (ops/kernels/resnetfc.py
// wgrad_plan's layout, the bf16 wgrad's); wgrad_reduce adds them.
struct WgradJob {
  const void* G;
  const void* A;
  int rows, ldg, lda, Mg, Ka, chunk, tiles, tiles_i, first_block;
  long long part;   // float offset of the job's partial tiles [split][Mg][Ka]
  long long bpart;  // float offset of its bias partials [split][tiles_i][Mg]; -1: no bias
};

constexpr int MAX_JOBS = 24;
constexpr int WT = 128;        // dW tile edge
constexpr int WG_ROWS = 32;    // rows a pipeline stage
constexpr int WG_STAGES = 3;   // stages of the cp.async ring
constexpr int WG_STEP = 32;    // a split's rows: a multiple of this (wgrad_plan's WGRAD_ROWS_F32)
constexpr int WG_STAGE = 2 * WG_ROWS * WT;             // floats a stage: G rows, then A rows
constexpr int WG_SMEM = WG_STAGES * WG_STAGE * 4;      // 96 KB
constexpr int WG_CTAS = 2;                             // CTAs an SM (128 registers a thread)
// the ring also holds the thread groups' sums at the end (at most 7 groups
// of 32 threads x 64 values)
static_assert(WG_SMEM >= (256 - 32) * 64 * 4, "the ring holds the groups' sums");

struct WgradArgs {
  WgradJob job[MAX_JOBS];
  int n_jobs;
};

// rows [n0, n0 + WG_ROWS) x cols [c0, c0 + W) of X (row stride ldx; rows
// < rows and cols < ncols are valid) -> Xs[n - n0][c - c0] (row stride
// WT), zeros outside, by the CTA's 256 threads.  Whole valid 16-byte
// vectors go by cp.async (the caller commits and waits); the rest is
// stored directly.
template <int W>
__device__ __forceinline__ void wg_load(const float* X, int ldx, int rows, int ncols, int n0,
                                        int c0, float* Xs) {
  constexpr int NV = W / 4, PER = (WG_ROWS * NV + 255) / 256;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int idx = threadIdx.x + q * 256;
    if (PER * 256 > WG_ROWS * NV && idx >= WG_ROWS * NV) break;
    const int n = idx / NV, cv = idx % NV, c = c0 + cv * 4;
    float* dst = Xs + n * WT + cv * 4;
    const bool live = n0 + n < rows && c < ncols;
    const float* src = X + (size_t)(n0 + n) * ldx + c;
    if (live && c + 4 <= ncols) {
      cp_async16(dst, src);
      continue;
    }
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {  // a partly valid vector (inside the row: ldx is a multiple of 4)
      val = __ldg(reinterpret_cast<const float4*>(src));
      if (c + 1 >= ncols) val.y = 0.f;
      if (c + 2 >= ncols) val.z = 0.f;
      val.w = 0.f;
    }
    *reinterpret_cast<float4*>(dst) = val;
  }
}

// One (split, tile) CTA's share of a job.  Thread layout: KSPLIT = 256 /
// (TO x TC) groups of TO x TC threads, group kg taking the rows k = kg
// (mod KSPLIT) of each stage; a thread owns 8 x 8 outputs, rows ty 4 +
// {0..3} and 4 TO + ty 4 + {0..3}, columns tx 4 + {0..3} and 4 TC + tx 4 +
// {0..3}, so a group covers 8 TO x 8 TC of the 128 x 128 tile (the narrow
// modes keep a skinny job's threads on its valid outputs).  A warp is 4 (ty)
// x 8 (tx): per row it reads 4 and 8 distinct 16-byte vectors of G and A, no
// bank conflicts, 4 vector loads for 64 FMAs.  The groups' sums meet in
// shared memory at the end, added in group order.
template <int TO, int TC>
__device__ __forceinline__ void wgrad_f32_tile(const WgradJob& job, float* smem,
                                               float* __restrict__ part, int split, int to,
                                               int ti) {
  constexpr int GT = TO * TC, KSPLIT = 256 / GT, CO = 4 * TO, CC = 4 * TC;
  const int tid = threadIdx.x, kg = tid / GT, t = tid % GT, lane = tid & 31, wg = t >> 5;
  const int ty = (wg / (TC / 8)) * 4 + (lane >> 3), tx = (wg % (TC / 8)) * 8 + (lane & 7);
  const int o0 = to * WT, i0 = ti * WT;
  const int r_begin = split * job.chunk, r_end = min(job.rows, r_begin + job.chunk);
  const int steps = (r_end - r_begin + WG_ROWS - 1) / WG_ROWS;
  const float* G = static_cast<const float*>(job.G);
  const float* A = static_cast<const float*>(job.A);
  // the bias sums are shared by the row range's column tiles: tile ti sums
  // the stages s with s % tiles_i == ti
  const bool bias = job.bpart >= 0 && tid < 8 * TO;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;
  auto load = [&](int step) {
    float* st = smem + (step % WG_STAGES) * WG_STAGE;
    const int n0 = r_begin + step * WG_ROWS;
    wg_load<8 * TO>(G, job.ldg, r_end, job.Mg, n0, o0, st);
    wg_load<8 * TC>(A, job.lda, r_end, job.Ka, n0, i0, st + WG_ROWS * WT);
  };
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // this step's rows have landed, and every thread is done with step - 1
    if (step + WG_STAGES - 1 < steps) load(step + WG_STAGES - 1);  // into step - 1's stage
    cp_async_commit();
    const float* Gs = smem + (step % WG_STAGES) * WG_STAGE;
    const float* As = Gs + WG_ROWS * WT;
    if (bias && step % job.tiles_i == ti)
      for (int k = 0; k < WG_ROWS; ++k) bsum += Gs[k * WT + tid];
    const float* gp = Gs + kg * WT + ty * 4;
    const float* ap = As + kg * WT + tx * 4;
    float4 g0 = *reinterpret_cast<const float4*>(gp);
    float4 g1 = *reinterpret_cast<const float4*>(gp + CO);
    float4 a0 = *reinterpret_cast<const float4*>(ap);
    float4 a1 = *reinterpret_cast<const float4*>(ap + CC);
#pragma unroll
    for (int kk = 0; kk < WG_ROWS / KSPLIT; ++kk) {
      float4 ng0 = g0, ng1 = g1, na0 = a0, na1 = a1;
      if (kk + 1 < WG_ROWS / KSPLIT) {
        const int o = (kk + 1) * KSPLIT * WT;
        ng0 = *reinterpret_cast<const float4*>(gp + o);
        ng1 = *reinterpret_cast<const float4*>(gp + o + CO);
        na0 = *reinterpret_cast<const float4*>(ap + o);
        na1 = *reinterpret_cast<const float4*>(ap + o + CC);
      }
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      g0 = ng0; g1 = ng1; a0 = na0; a1 = na1;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(gv[i], av[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  if (KSPLIT > 1) {  // the groups' sums, added in group order by group 0
    if (kg > 0)
#pragma unroll
      for (int e = 0; e < 64; ++e) smem[((kg - 1) * 64 + e) * GT + t] = acc[e >> 3][e & 7];
    __syncthreads();
    if (kg == 0)
      for (int q = 1; q < KSPLIT; ++q)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e >> 3][e & 7] += smem[((q - 1) * 64 + e) * GT + t];
  }
  // the partial tile (every valid element of it: rows past the range added zeros)
  if (kg == 0) {
    float* dst = part + job.part + (size_t)split * job.Mg * job.Ka;
    const bool vec = (job.Ka & 3) == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = o0 + (i < 4 ? ty * 4 + i : CO + ty * 4 + i - 4);
      if (o >= job.Mg) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = i0 + h * CC + tx * 4;
        float* d = dst + (size_t)o * job.Ka + c;
        if (vec && c + 4 <= job.Ka) {
          *reinterpret_cast<float4*>(d) = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                                      acc[i][4 * h + 2], acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c + q < job.Ka) d[q] = acc[i][4 * h + q];
        }
      }
    }
  }
  if (bias && o0 + tid < job.Mg)
    part[job.bpart + ((size_t)split * job.tiles_i + ti) * job.Mg + o0 + tid] = bsum;
}

__global__ void __launch_bounds__(256, WG_CTAS)
resnetfc_wgrad_f32_kernel(const __grid_constant__ WgradArgs args, float* __restrict__ part) {
  extern __shared__ __align__(16) float wg_smem[];
  int j = 0;
  while (j + 1 < args.n_jobs && (int)blockIdx.x >= args.job[j + 1].first_block) ++j;
  const WgradJob& job = args.job[j];
  // block -> (split, tile), the tiles of one row range adjacent
  const int local = blockIdx.x - job.first_block;
  const int split = local / job.tiles, tile = local % job.tiles;
  const int to = tile / job.tiles_i, ti = tile % job.tiles_i;
  // the mode: the thread groups' cover of the tile's valid outputs
  const int vo = min(WT, job.Mg - to * WT), vc = min(WT, job.Ka - ti * WT);
  const int mo = vo > 64 ? 16 : vo > 32 ? 8 : 4;
  if (vc > 64) {
    if (mo == 16) wgrad_f32_tile<16, 16>(job, wg_smem, part, split, to, ti);
    else if (mo == 8) wgrad_f32_tile<8, 16>(job, wg_smem, part, split, to, ti);
    else wgrad_f32_tile<4, 16>(job, wg_smem, part, split, to, ti);
  } else {
    if (mo == 16) wgrad_f32_tile<16, 8>(job, wg_smem, part, split, to, ti);
    else if (mo == 8) wgrad_f32_tile<8, 8>(job, wg_smem, part, split, to, ti);
    else wgrad_f32_tile<4, 8>(job, wg_smem, part, split, to, ti);
  }
}

// plan: per job (rows, ldg, lda, Mg, Ka, tiles_i, tiles, splits, chunk,
// group, first_block, part, bpart) as ops/kernels/resnetfc.py wgrad_plan
// makes it for float32: one launch (group 0) of at most MAX_JOBS jobs, then
// wgrad_reduce over every job.
extern "C" int avr_resnetfc_wgrad(const void* const* G, const void* const* A, void* const* dW,
                                  void* const* db, const long long* plan, int n_jobs, void* part,
                                  void* stream) {
  if (n_jobs > MAX_JOBS || n_jobs < 1) return (int)cudaErrorInvalidValue;
  WgradArgs args;
  ReduceArgs r;
  int blocks = 0;
  long long total = 0;
  for (int j = 0; j < n_jobs; ++j) {
    const long long* q = plan + j * WGRAD_PLAN_W;
    WgradJob& w = args.job[j];
    w.G = G[j]; w.A = A[j];
    w.rows = (int)q[0]; w.ldg = (int)q[1]; w.lda = (int)q[2]; w.Mg = (int)q[3];
    w.Ka = (int)q[4]; w.tiles_i = (int)q[5]; w.tiles = (int)q[6]; w.chunk = (int)q[8];
    w.first_block = (int)q[10]; w.part = q[11]; w.bpart = db[j] ? q[12] : -1;
    if (q[9] != 0 || w.chunk % WG_STEP || w.chunk < 1 || w.first_block != blocks)
      return (int)cudaErrorInvalidValue;
    blocks += w.tiles * (int)q[7];
    ReduceJob& rj = r.job[j];
    rj.dW = (float*)dW[j]; rj.db = (float*)db[j]; rj.part = w.part; rj.bpart = w.bpart;
    rj.first = total; rj.Mg = w.Mg; rj.Ka = w.Ka; rj.splits = (int)q[7];
    rj.bsplits = (int)q[7] * w.tiles_i;
    if ((long long)w.Mg * w.Ka % 4 || w.part % 4) return (int)cudaErrorInvalidValue;
    total += (long long)w.Mg * w.Ka / 4 + (db[j] ? w.Mg : 0);
  }
  args.n_jobs = n_jobs;
  r.n_jobs = n_jobs;
  r.total = total;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t c = cudaFuncSetAttribute(resnetfc_wgrad_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (c != cudaSuccess) return (int)c;
  resnetfc_wgrad_f32_kernel<<<blocks, 256, WG_SMEM, s>>>(args, (float*)part);
  c = cudaGetLastError();
  if (c != cudaSuccess) return (int)c;
  return wgrad_reduce(r, (const float*)part, s);
}
