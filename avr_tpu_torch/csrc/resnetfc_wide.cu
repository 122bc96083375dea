// K2's wide kernels: the forward and the dgrad for decoder shapes past the
// register-resident kernels' envelopes, each templated on the operand type
// T (bf16 on mma.sync.m16n8k16; float32 on FMA, no TF32).
//
// Replaces, for those shapes, avr_tpu/ops/pallas/resnetfc.py's forward
// fused_resnetfc (:896, kernel call :726, stash outputs :637-653) and the
// dgrad half of its stash backward _bwd_stash_impl (:400-575, call :823);
// run per chunk as the stash forward into the chunk's workspace and the
// dgrad, the recompute backward _bwd_impl (:248-390, call :853).  The
// wgrads stay csrc/resnetfc_hopper.cu's (bf16) and csrc/resnetfc.cu's
// (float32), which take jobs of any width.  ops/kernels/resnetfc.py
// forward_route and backward_route send a shape here when it is past the
// other kernels' envelopes: d_hidden above 512 in either dtype (the
// register-resident trunks of resnetfc_fwd_wgmma_kernel, resnetfc_kernel,
// resnetfc_fwd_f32_kernel and both dgrads are full at 512), and, for the
// bf16 dgrad, d_latent above 512 or more than 128 encoded input lanes (the
// dgrad tail's tiles).
//
// Design (a first version: simple and right).  A CTA takes a tile of WTM
// points (bf16 32, float32 16) and keeps the float32 trunk h (forward) or
// trunk cotangent gh (dgrad) in shared memory, WTM x (d_hidden + 4) floats,
// beside one operand tile As (WTM rows in T).  The warps take a product's
// 64-column groups in turn (warp w: groups w, w + warps, ...), each group's
// accumulator in registers over the product's whole K, and add it into the
// shared trunk in the same order as the register kernels (h = (h + acc) +
// b), so every rounding point is the register kernels' and the plain
// version's.  Weights are read from L2 as the mma.sync forward reads them:
// bf16 in nn.Linear (out, in) rows (the mma's column-major B fragment: the
// forward the weights as they are, the dgrad their transposed copies);
// float32 along output columns (the forward the transposed copies, the dgrad
// the weights as they are), 16 bytes a load.  At d_hidden 1,024 and a
// latent of 1,152 the bf16 weights are ~28 MB: they stay in the 50 MB L2.
// An operand that is the trunk itself (fc_0's relu(h); the dgrad's fc_1
// input round(gh)) is read from the shared trunk and rounded on the fly, so
// the product's output can go to As while the product runs; every other
// operand is staged in As (the encoding, the latent rows, fc_0's output,
// the masked fc_1 cotangent).  Shared memory (227 KB a block): bf16 at
// d_hidden 1,024, a latent of 1,152: 131,584 + 75,776 bytes; float32:
// 65,792 + 73,984.  Bound on an H100 SXM (989 TFLOP/s bf16, 67 float32, at
// its 700 W limit): operations (28.2 MFLOP a point forward at d_hidden
// 1,024, 5 blocks, 3 injections, a latent of 1,152: 2.33 ms at 81,920
// points in bf16); the first version is far from it (chip_smoke.py phase
// 11 times both kernels; PERF.md records the readings with the card's name
// and power limit).
//
// The dgrad walks a tile's chain in reverse with the rounding and mask
// order of the other dgrads (chip_smoke.py decoder_bwd_matched,
// csrc/resnetfc.cu resnetfc_dgrad_f32_kernel): lin_out's cotangent g_epi =
// g * act'(out_pre), rounded, to gout; gh = mask(relu(h_final)) * (g_epi @
// Wo); per block c1 = round(gh) (its cotangent slot), c0 = round(mask(
// relu(fc_0)) * (c1 @ W1)) (its slot), gh += mask(relu(h)) * (c0 @ W0);
// the pooled cotangent over NS > 1 as the walk pools it.  Its own tail per
// view: cot_in = round(gh) (its slot); d encoding = cot_in @ Wi in column
// chunks of at most d_hidden (the trunk's shared tile holds them), summed
// onto dx through the encoding's cos lanes; the encoded input to enc; dz =
// sum over the injections j (ascending) of G_j @ Wz_j in one float32 sum,
// rounded once, as the bf16 tail kernel forms it, with G_j the rounded
// cotangent rows this CTA stored.  No float atomics: every output has one
// writer and one order, the same bits on every run.

#include "resnetfc.cuh"

#include <type_traits>

namespace {

constexpr int SMEM_MAX = 232448;  // bytes of shared memory a Hopper block can use

// The tile: points a CTA, its warps, the accumulator floats a thread holds
// for one 64-column group.
template <typename T> struct Wide;
template <> struct Wide<bf16> {
  static constexpr int TM = 32, WARPS = 8, NACC = 64;
};
template <> struct Wide<float> {
  static constexpr int TM = 16, WARPS = 16, NACC = 32;
};

// As's row stride (elements) for rows of k values: bf16 rows 64 bytes apart
// modulo 128 (the 16-byte fragment loads of 8 lanes hit 8 bank groups);
// float32 rows 16 bytes apart modulo 128.
template <typename T> __host__ __device__ inline int wide_lda(int k);
template <> __host__ __device__ inline int wide_lda<bf16>(int k) { return (k + 63) / 64 * 64 + 32; }
template <> __host__ __device__ inline int wide_lda<float>(int k) { return k + 4; }

template <typename T> __host__ __device__ inline size_t wide_fwd_smem(int dh, int dl, int k_in) {
  const int k = dh > dl ? (dh > k_in ? dh : k_in) : (dl > k_in ? dl : k_in);
  return (size_t)Wide<T>::TM * (dh + 4) * 4 + (size_t)Wide<T>::TM * wide_lda<T>(k) * sizeof(T);
}
template <typename T> __host__ __device__ inline size_t wide_dgrad_smem(int dh) {
  return (size_t)Wide<T>::TM * (dh + 4) * 4 + (size_t)Wide<T>::TM * wide_lda<T>(dh) * sizeof(T) +
         (size_t)Wide<T>::TM * GOUT_W * 4;
}

// Where a product's A operand comes from: As (T), the shared float32 trunk
// relu'd and rounded, the trunk rounded, or rows of T in device memory
// (rows at or past nv read as zeros).
enum { A_SMEM, A_RELU_H, A_ROUND_H, A_GLOBAL };

__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

// 8 bf16 of row `row` from column k of the A operand.
template <int AM>
__device__ __forceinline__ uint4 a_bf16(const void* A, int ld, int row, int k, int nv) {
  if (AM == A_SMEM)
    return *reinterpret_cast<const uint4*>(static_cast<const bf16*>(A) + row * ld + k);
  if (AM == A_GLOBAL) {
    if (row >= nv) return make_uint4(0u, 0u, 0u, 0u);
    return *reinterpret_cast<const uint4*>(static_cast<const bf16*>(A) + (size_t)row * ld + k);
  }
  const float* h = static_cast<const float*>(A) + row * ld + k;
  float4 p = *reinterpret_cast<const float4*>(h), q = *reinterpret_cast<const float4*>(h + 4);
  if (AM == A_RELU_H) {
    p = make_float4(relu(p.x), relu(p.y), relu(p.z), relu(p.w));
    q = make_float4(relu(q.x), relu(q.y), relu(q.z), relu(q.w));
  }
  return make_uint4(bf2(p.x, p.y), bf2(p.z, p.w), bf2(q.x, q.y), bf2(q.z, q.w));
}

// acc += A (32 x K) B for the 64 columns from col0; B is W's rows
// col0 .. col0 + 63, ldw apart, K-contiguous (W[n * ldw + k]).  The
// fragment layout of csrc/resnetfc.cu gemm_tile: acc[32 mt + 4 nt + i] is
// row 16 mt + g + 8 (i >> 1), column col0 + 8 nt + 2 t + (i & 1) for lane
// (g = lane / 4, t = lane % 4); within each 32-wide k slab a thread reads k
// = 8 t .. 8 t + 7 of its A rows and B columns, a consistent permutation of
// k for A and B.
template <int AM>
__device__ __forceinline__ void kloop(float (&acc)[64], const void* A, int lda, int nv,
                                      const bf16* __restrict__ W, int ldw, int K, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 32) {
    uint4 a[2][2], b[8];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      a[mt][0] = a_bf16<AM>(A, lda, mt * 16 + g, k0 + 8 * t, nv);
      a[mt][1] = a_bf16<AM>(A, lda, mt * 16 + g + 8, k0 + 8 * t, nv);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      b[nt] = __ldg(
          reinterpret_cast<const uint4*>(W + (size_t)(col0 + nt * 8 + g) * ldw + k0 + 8 * t));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t lo[4] = {a[mt][0].x, a[mt][1].x, a[mt][0].y, a[mt][1].y};
        const uint32_t hi[4] = {a[mt][0].z, a[mt][1].z, a[mt][0].w, a[mt][1].w};
        mma_m16n8k16(acc + mt * 32 + nt * 4, lo, b[nt].x, b[nt].y);
        mma_m16n8k16(acc + mt * 32 + nt * 4, hi, b[nt].z, b[nt].w);
      }
  }
}

// 4 floats of row `row` from column k of the A operand.
template <int AM>
__device__ __forceinline__ float4 a_f32(const void* A, int ld, int row, int k, int nv) {
  if (AM == A_GLOBAL && row >= nv) return make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v = *reinterpret_cast<const float4*>(static_cast<const float*>(A) + (size_t)row * ld + k);
  if (AM == A_RELU_H) v = make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w));
  return v;
}

// acc += A (16 x K) B for the 64 columns from col0; B is W's k rows, ldw
// apart, column-contiguous (W[k * ldw + n]).  acc[8 i + j] is point tp + 4
// i (tp = lane / 8) and column col0 + 4 tc + j (j < 4) or col0 + 32 + 4 tc
// + j - 4 (tc = lane % 8): a warp's 8 column groups read 128 contiguous
// bytes of a weight row per load.  Each output is one FMA chain in k order.
template <int AM>
__device__ __forceinline__ void kloop(float (&acc)[32], const void* A, int lda, int nv,
                                      const float* __restrict__ W, int ldw, int K, int col0) {
  const int lane = threadIdx.x & 31, tp = lane >> 3, tc = lane & 7;
  const int c0 = col0 + 4 * tc, c1 = col0 + 32 + 4 * tc;
  for (int k4 = 0; k4 < K; k4 += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_f32<AM>(A, lda, tp + 4 * i, k4, nv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(W + (size_t)(k4 + kk) * ldw + c0));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(W + (size_t)(k4 + kk) * ldw + c1));
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[8 * i + j] = fmaf(av, bv[j], acc[8 * i + j]);
      }
    }
  }
}

// Accumulator element e's row and column (col0 its group's first column).
__device__ __forceinline__ int acc_r(const float (&)[64], int e) {
  return (e >> 5) * 16 + ((threadIdx.x & 31) >> 2) + 8 * ((e & 3) >> 1);
}
__device__ __forceinline__ int acc_c(const float (&)[64], int e, int col0) {
  return col0 + ((e >> 2) & 7) * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}
__device__ __forceinline__ int acc_r(const float (&)[32], int e) {
  return ((threadIdx.x & 31) >> 3) + 4 * (e >> 3);
}
__device__ __forceinline__ int acc_c(const float (&)[32], int e, int col0) {
  const int j = e & 7;
  return col0 + (j < 4 ? 0 : 28) + 4 * (threadIdx.x & 7) + j;
}

// One product: for each of this warp's 64-column groups of [c_begin,
// c_end), acc = A B (B's rows from W, the weight's row stride ldw: bf16
// along K, float32 along the columns), then epi(acc, col0).
template <typename T, int AM, typename Epi>
__device__ __forceinline__ void product(const void* A, int lda, int nv, const T* W, int ldw, int K,
                                        int c_begin, int c_end, Epi&& epi) {
  float acc[Wide<T>::NACC];
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int col0 = c_begin + 64 * warp; col0 < c_end; col0 += 64 * warps) {
#pragma unroll
    for (int e = 0; e < Wide<T>::NACC; ++e) acc[e] = 0.f;
    kloop<AM>(acc, A, lda, nv, W, ldw, K, col0);
    epi(acc, col0);
  }
}

// rows [0, nv) of the shared tile As (width w, row stride lda) -> device
// rows r0.. of dst (row stride w), 16-byte copies
template <typename T>
__device__ __forceinline__ void rows_out(const T* As, int lda, T* dst, int r0, int nv, int w) {
  constexpr int V = Vec16<T>::N;
  const int nvec = w / V;
  for (int idx = threadIdx.x; idx < nv * nvec; idx += blockDim.x) {
    const int r = idx / nvec, cv = idx - r * nvec;
    *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * w + cv * V) =
        *reinterpret_cast<const uint4*>(As + r * lda + cv * V);
  }
}

// rows [0, nv) of the shared trunk (row stride ldh), relu'd when RELU, rounded
// to T -> device rows r0.. of dst (row stride dh)
template <typename T, bool RELU>
__device__ __forceinline__ void trunk_out(const float* Hs, int ldh, T* dst, int r0, int nv,
                                          int dh) {
  for (int idx = threadIdx.x; idx < nv * dh; idx += blockDim.x) {
    const int r = idx / dh, c = idx - r * dh;
    const float v = Hs[r * ldh + c];
    dst[(size_t)(r0 + r) * dh + c] = from_f<T>(RELU ? relu(v) : v);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// a.wi, wz, w0, w1: bf16 as nn.Linear keeps them, (dh, k_in), (n_lin_z, dh,
// dl), (n_blocks, dh, dh) twice; float32 transposed, (k_in, dh), (n_lin_z,
// dl, dh), (n_blocks, dh, dh) twice.  a.pool: NS > 1, WTM x dh floats a tile.
template <typename T>
__global__ void __launch_bounds__(Wide<T>::WARPS * 32, 1)
resnetfc_wide_fwd_kernel(const __grid_constant__ FcArgs a) {
  constexpr int TM = Wide<T>::TM, V = Vec16<T>::N;
  constexpr bool NK = std::is_same<T, bf16>::value;  // weights along K (bf16) or columns
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int dh = a.d_hidden, dl = a.d_latent, k_in = a.k_in, N = a.N;
  const int ldh = dh + 4, lda = wide_lda<T>(max(dh, max(dl, k_in)));
  float* Hs = reinterpret_cast<float*>(wide_smem);
  T* As = reinterpret_cast<T*>(Hs + TM * ldh);
  const int r0 = blockIdx.x * TM, nv = min(TM, N - r0), tid = threadIdx.x, nt = blockDim.x;
  const T* wi = static_cast<const T*>(a.wi);
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  T* stash = static_cast<T*>(a.stash);
  const size_t slot = (size_t)N * dh;
  auto st = [&](int k, int j, int v) -> T* {
    return stash ? stash + stash_slot(k, j, v, a.ns, a.n_lin_z) * slot : nullptr;
  };
  float* pool = a.pool + (size_t)blockIdx.x * TM * dh;  // NS > 1: the view sum

  // h = h + relu(relu(h) @ W0 + b0) @ W1 + b1, the two activations to the
  // stash when it is kept
  auto block = [&](int k, int v) {
    __syncthreads();  // h is complete and every warp is done reading As
    if (stash) trunk_out<T, true>(Hs, ldh, st(k, 0, v), r0, nv, dh);
    const float* b0 = a.b0 + (size_t)k * dh;
    product<T, A_RELU_H>(Hs, ldh, nv, w0 + (size_t)k * dh * dh, dh, dh, 0, dh,
                         [&](const float (&acc)[Wide<T>::NACC], int col0) {
#pragma unroll
      for (int e = 0; e < Wide<T>::NACC; ++e) {
        const int r = acc_r(acc, e), c = acc_c(acc, e, col0);
        As[r * lda + c] = from_f<T>(relu(acc[e] + b0[c]));
      }
    });
    __syncthreads();
    if (stash) rows_out(As, lda, st(k, 1, v), r0, nv, dh);
    const float* b1 = a.b1 + (size_t)k * dh;
    product<T, A_SMEM>(As, lda, nv, w1 + (size_t)k * dh * dh, dh, dh, 0, dh,
                       [&](const float (&acc)[Wide<T>::NACC], int col0) {
#pragma unroll
      for (int e = 0; e < Wide<T>::NACC; ++e) {
        const int r = acc_r(acc, e), c = acc_c(acc, e, col0);
        float& h = Hs[r * ldh + c];
        h = (h + acc[e]) + b1[c];
      }
    });
  };

  for (int v = 0; v < a.ns; ++v) {
    __syncthreads();  // the previous view is done with As and h
    for (int idx = tid; idx < TM * k_in; idx += nt) {
      const int r = idx / k_in, j = idx - r * k_in, row = r0 + r;
      const int mode = a.tables[j];
      float val = 0.f;
      if (row < N && mode != 2) {
        const float p = a.x[((size_t)v * N + row) * a.d_in + a.tables[k_in + j]];
        val = mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[k_in + j]));
      }
      As[r * lda + j] = from_f<T>(val);
    }
    __syncthreads();
    product<T, A_SMEM>(As, lda, nv, wi, NK ? k_in : dh, k_in, 0, dh,
                       [&](const float (&acc)[Wide<T>::NACC], int col0) {
#pragma unroll
      for (int e = 0; e < Wide<T>::NACC; ++e) {
        const int r = acc_r(acc, e), c = acc_c(acc, e, col0);
        Hs[r * ldh + c] = acc[e] + a.bi[c];
      }
    });
    for (int k = 0; k < a.n_lin_z; ++k) {
      __syncthreads();  // every warp is done reading As
      const int nvec = dl / V;
      const T* zg = static_cast<const T*>(a.z) + ((size_t)v * N + r0) * dl;
      for (int idx = tid; idx < TM * nvec; idx += nt) {
        const int r = idx / nvec, cv = idx - r * nvec;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < nv) val = __ldg(reinterpret_cast<const uint4*>(zg + (size_t)r * dl) + cv);
        *reinterpret_cast<uint4*>(As + r * lda + cv * V) = val;
      }
      __syncthreads();
      const float* bz = a.bz + (size_t)k * dh;
      product<T, A_SMEM>(As, lda, nv, wz + (size_t)k * dh * dl, NK ? dl : dh, dl, 0, dh,
                         [&](const float (&acc)[Wide<T>::NACC], int col0) {
#pragma unroll
        for (int e = 0; e < Wide<T>::NACC; ++e) {
          const int r = acc_r(acc, e), c = acc_c(acc, e, col0);
          float& h = Hs[r * ldh + c];
          h = (h + acc[e]) + bz[c];
        }
      });
      block(k, v);
    }
    if (a.ns > 1) {
      __syncthreads();
      for (int idx = tid; idx < TM * dh; idx += nt) {
        const int r = idx / dh, c = idx - r * dh;
        pool[idx] = v == 0 ? Hs[r * ldh + c] : pool[idx] + Hs[r * ldh + c];
      }
    }
  }
  if (a.ns > 1) {  // each thread its own pool entries: h = sum / NS
    const float inv = 1.f / (float)a.ns;
    for (int idx = tid; idx < TM * dh; idx += nt) {
      const int r = idx / dh, c = idx - r * dh;
      Hs[r * ldh + c] = pool[idx] * inv;
    }
  }
  for (int k = a.n_lin_z; k < a.n_blocks; ++k) block(k, 0);

  // relu -> lin_out (d_out is small: one thread a (point, output), as the
  // register kernels do it)
  __syncthreads();
  for (int idx = tid; idx < TM * dh; idx += nt) {
    const int r = idx / dh, c = idx - r * dh;
    As[r * lda + c] = from_f<T>(relu(Hs[r * ldh + c]));
  }
  __syncthreads();
  if (stash)
    rows_out(As, lda, stash + (size_t)(stash_slots(a.ns, a.n_blocks, a.n_lin_z) - 1) * slot, r0,
             nv, dh);
  const T* wo = static_cast<const T*>(a.wo);
  for (int idx = tid; idx < TM * a.d_out; idx += nt) {
    const int r = idx / a.d_out, o = idx - r * a.d_out;
    if (r >= nv) continue;
    const T* arow = As + r * lda;
    const T* wrow = wo + (size_t)o * dh;
    float s = 0.f;
    for (int k = 0; k < dh; ++k) s = fmaf(to_f(arow[k]), to_f(wrow[k]), s);
    s = s + a.bo[o];
    if (a.activate) s = o < 3 ? sigmoidf_(s) : fmaxf(s, 0.f);
    a.out[(size_t)(r0 + r) * a.d_out + o] = s;
  }
}

// ---------------------------------------------------------------------------
// dgrad
// ---------------------------------------------------------------------------

// a.wi, wz, w0, w1: bf16 the transposed copies, (k_in, dh), (n_lin_z, dl,
// dh), (n_blocks, dh, dh) twice; float32 as nn.Linear keeps them, (dh, k_in),
// (n_lin_z, dh, dl), (n_blocks, dh, dh) twice.  a.pool: NS > 1, WTM x dh
// floats a tile.
template <typename T>
__global__ void __launch_bounds__(Wide<T>::WARPS * 32, 1)
resnetfc_wide_dgrad_kernel(const __grid_constant__ FcBwdArgs a) {
  constexpr int TM = Wide<T>::TM;
  constexpr bool NK = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int dh = a.d_hidden, dl = a.d_latent, k_in = a.k_in, N = a.N, ns = a.ns;
  const int nb = a.n_blocks, nlz = a.n_lin_z;
  const int ldh = dh + 4, lda = wide_lda<T>(dh);
  float* Hs = reinterpret_cast<float*>(wide_smem);  // gh; in a view's tail the d-encoding chunk
  T* As = reinterpret_cast<T*>(Hs + TM * ldh);
  float* gs = reinterpret_cast<float*>(As + TM * lda);  // g_epi, TM x GOUT_W
  const int r0 = blockIdx.x * TM, nv = min(TM, N - r0), tid = threadIdx.x, nt = blockDim.x;
  const T* wi = static_cast<const T*>(a.wi);
  const T* wz = static_cast<const T*>(a.wz);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* stash = static_cast<const T*>(a.stash);
  T* cot = static_cast<T*>(a.cot);
  const size_t slot = (size_t)N * dh;
  const T* aout = stash + (size_t)(stash_slots(ns, nb, nlz) - 1) * slot;
  const T* wo = static_cast<const T*>(a.wo);

  // lin_out: g_epi = g * act'(out_pre), rounded (0 past d_out), to gout
  for (int idx = tid; idx < TM * GOUT_W; idx += nt) {
    const int r = idx / GOUT_W, o = idx - r * GOUT_W, row = r0 + r;
    float gv = 0.f;
    if (row < N && o < a.d_out) {
      gv = a.g[(size_t)row * a.d_out + o];
      if (a.activate) {
        const T* arow = aout + (size_t)row * dh;
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
  // gh = mask(relu(h_final)) * (g_epi @ Wo)
  for (int idx = tid; idx < TM * dh; idx += nt) {
    const int r = idx / dh, c = idx - r * dh, row = r0 + r;
    float v = 0.f;
    if (row < N) {
      float sum = 0.f;
      for (int o = 0; o < a.d_out; ++o)
        sum = fmaf(gs[r * GOUT_W + o], to_f(wo[(size_t)o * dh + c]), sum);
      v = to_f(aout[(size_t)row * dh + c]) > 0.f ? sum : 0.f;
    }
    Hs[r * ldh + c] = v;
  }

  // block k of view v, backward: c1 = round(gh); c0 = round(mask(relu(fc_0))
  // * (c1 @ W1)); gh += mask(relu(h)) * (c0 @ W0)
  auto block = [&](int k, int v) {
    __syncthreads();  // gh is complete and every warp is done reading As
    trunk_out<T, false>(Hs, ldh, cot + stash_slot(k, 1, v, ns, nlz) * slot, r0, nv, dh);
    const T* m1 = stash + stash_slot(k, 1, v, ns, nlz) * slot + (size_t)r0 * dh;
    product<T, A_ROUND_H>(Hs, ldh, nv, w1 + (size_t)k * dh * dh, dh, dh, 0, dh,
                          [&](const float (&acc)[Wide<T>::NACC], int col0) {
#pragma unroll
      for (int e = 0; e < Wide<T>::NACC; ++e) {
        const int r = acc_r(acc, e), c = acc_c(acc, e, col0);
        const bool on = r < nv && to_f(__ldg(m1 + (size_t)r * dh + c)) > 0.f;
        As[r * lda + c] = from_f<T>(on ? acc[e] : 0.f);
      }
    });
    __syncthreads();
    rows_out(As, lda, cot + stash_slot(k, 0, v, ns, nlz) * slot, r0, nv, dh);
    const T* m0 = stash + stash_slot(k, 0, v, ns, nlz) * slot + (size_t)r0 * dh;
    product<T, A_SMEM>(As, lda, nv, w0 + (size_t)k * dh * dh, dh, dh, 0, dh,
                       [&](const float (&acc)[Wide<T>::NACC], int col0) {
#pragma unroll
      for (int e = 0; e < Wide<T>::NACC; ++e) {
        const int r = acc_r(acc, e), c = acc_c(acc, e, col0);
        if (r < nv && to_f(__ldg(m0 + (size_t)r * dh + c)) > 0.f) Hs[r * ldh + c] += acc[e];
      }
    });
  };

  // the view's tail: cot_in, dx and enc through lin_in's backward, dz
  auto tail = [&](int v) {
    __syncthreads();
    for (int idx = tid; idx < TM * dh; idx += nt) {
      const int r = idx / dh, c = idx - r * dh;
      As[r * lda + c] = from_f<T>(Hs[r * ldh + c]);
    }
    __syncthreads();
    T* ci = cot + cot_in_slot(v, ns, nb, nlz) * slot;
    rows_out(As, lda, ci, r0, nv, dh);
    // d encoding = cot_in @ Wi in chunks of at most dh columns into Hs
    // (gh is no longer needed), each summed onto dx
    for (int cb = 0; cb < k_in; cb += dh) {
      const int cw = min(dh, k_in - cb);
      product<T, A_SMEM>(As, lda, nv, wi, NK ? dh : k_in, dh, cb, cb + cw,
                         [&](const float (&acc)[Wide<T>::NACC], int col0) {
#pragma unroll
        for (int e = 0; e < Wide<T>::NACC; ++e)
          Hs[acc_r(acc, e) * ldh + acc_c(acc, e, col0) - cb] = acc[e];
      });
      __syncthreads();
      for (int idx = tid; idx < TM * a.d_in; idx += nt) {
        const int r = idx / a.d_in, lane = idx - r * a.d_in, row = r0 + r;
        if (row >= N) continue;
        const size_t at = ((size_t)v * N + row) * a.d_in + lane;
        const float p = a.x[at];
        float sum = cb == 0 ? 0.f : a.dx[at];
        for (int jj = 0; jj < cw; ++jj) {
          const int j = cb + jj, mode = a.tables[j];
          if (mode == 2 || a.tables[k_in + j] != lane) continue;
          float d = Hs[r * ldh + jj];
          if (mode == 1)
            d = d * (cosf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[k_in + j])) * a.fph[j]);
          sum += d;
        }
        a.dx[at] = sum;
      }
      __syncthreads();  // the chunk is read before the next one is written
    }
    T* enc = static_cast<T*>(a.enc) + (size_t)v * N * k_in;
    for (int idx = tid; idx < TM * k_in; idx += nt) {
      const int r = idx / k_in, j = idx - r * k_in, row = r0 + r;
      if (row >= N) continue;
      const int mode = a.tables[j];
      float val = 0.f;
      if (mode != 2) {
        const float p = a.x[((size_t)v * N + row) * a.d_in + a.tables[k_in + j]];
        val = mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[k_in + j]));
      }
      enc[(size_t)row * k_in + j] = from_f<T>(val);
    }
    // dz = sum over j of G_j @ Wz_j, one float32 sum, rounded once; G_j the
    // rows this CTA stored (cot_in, then block j - 1's c1), read back
    T* dz = static_cast<T*>(a.dz) + (size_t)v * N * dl;
    float acc[Wide<T>::NACC];
    const int warp = tid >> 5, warps = nt >> 5;
    for (int col0 = 64 * warp; col0 < dl; col0 += 64 * warps) {
#pragma unroll
      for (int e = 0; e < Wide<T>::NACC; ++e) acc[e] = 0.f;
      for (int j = 0; j < nlz; ++j) {
        const int sj = j == 0 ? cot_in_slot(v, ns, nb, nlz) : stash_slot(j - 1, 1, v, ns, nlz);
        kloop<A_GLOBAL>(acc, cot + sj * slot + (size_t)r0 * dh, dh, nv,
                        wz + (size_t)j * dh * dl, NK ? dh : dl, dh, col0);
      }
#pragma unroll
      for (int e = 0; e < Wide<T>::NACC; ++e) {
        const int r = acc_r(acc, e);
        if (r < nv) dz[(size_t)(r0 + r) * dl + acc_c(acc, e, col0)] = from_f<T>(acc[e]);
      }
    }
  };

  // ns = 1 walks blocks nb - 1 .. 0 in one segment; ns > 1 the pooled
  // blocks, then per view its blocks from gh = the pooled cotangent / NS
  float* pool = a.pool + (size_t)blockIdx.x * TM * dh;
  if (ns == 1) {
    for (int k = nb - 1; k >= 0; --k) block(k, 0);
    tail(0);
    return;
  }
  for (int k = nb - 1; k >= nlz; --k) block(k, 0);
  __syncthreads();
  for (int idx = tid; idx < TM * dh; idx += nt) pool[idx] = Hs[(idx / dh) * ldh + idx % dh];
  const float inv_ns = 1.f / (float)ns;
  for (int v = 0; v < ns; ++v) {
    __syncthreads();  // the previous view's tail is done with Hs
    for (int idx = tid; idx < TM * dh; idx += nt)
      Hs[(idx / dh) * ldh + idx % dh] = pool[idx] * inv_ns;
    for (int k = nlz - 1; k >= 0; --k) block(k, v);
    tail(v);
  }
}

template <typename T>
int launch_fwd(const FcArgs& a, cudaStream_t s) {
  const size_t smem = wide_fwd_smem<T>(a.d_hidden, a.d_latent, a.k_in);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(resnetfc_wide_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((a.N + Wide<T>::TM - 1) / Wide<T>::TM);
  resnetfc_wide_fwd_kernel<T><<<blocks, Wide<T>::WARPS * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dgrad(const FcBwdArgs& a, cudaStream_t s) {
  const size_t smem = wide_dgrad_smem<T>(a.d_hidden);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(resnetfc_wide_dgrad_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((a.N + Wide<T>::TM - 1) / Wide<T>::TM);
  resnetfc_wide_dgrad_kernel<T><<<blocks, Wide<T>::WARPS * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

bool shape_ok(int N, int ns, int k_in, int d_latent, int d_hidden, int d_out, int n_blocks,
              int n_lin_z, int dtype) {
  return N >= 1 && ns >= 1 && d_hidden % 64 == 0 && d_hidden >= 64 && d_latent % 64 == 0 &&
         d_latent >= 64 && k_in % 64 == 0 && k_in >= 64 && d_out >= 1 && d_out <= GOUT_W &&
         n_lin_z >= 1 && n_lin_z <= n_blocks && (dtype == 0 || dtype == 1);
}

}  // namespace

// The forward, dtype 0 float32 (wi, wz, w0, w1 transposed), 1 bf16 (as
// nn.Linear keeps them).  Returns the launch's cudaError_t.
extern "C" int avr_resnetfc_fwd_wide(const void* x, const void* z, const void* wi, const void* bi,
                                     const void* wz, const void* bz, const void* w0,
                                     const void* b0, const void* w1, const void* b1,
                                     const void* wo, const void* bo, const void* tables,
                                     const void* fph, void* out, void* stash, void* pool, int N,
                                     int ns, int d_in, int k_in, int d_latent, int d_hidden,
                                     int d_out, int n_blocks, int n_lin_z, int activate, int dtype,
                                     void* stream) {
  const uintptr_t aligned = (uintptr_t)z | (uintptr_t)wi | (uintptr_t)wz | (uintptr_t)w0 |
                            (uintptr_t)w1 | (uintptr_t)stash;
  if (!shape_ok(N, ns, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z, dtype) ||
      (ns > 1 && !pool) || (aligned & 15))
    return (int)cudaErrorInvalidValue;
  FcArgs a;
  a.x = (const float*)x; a.z = z; a.wi = wi; a.bi = (const float*)bi;
  a.wz = wz; a.bz = (const float*)bz; a.w0 = w0; a.b0 = (const float*)b0;
  a.w1 = w1; a.b1 = (const float*)b1; a.wo = wo; a.bo = (const float*)bo;
  a.tables = (const int*)tables; a.fph = (const float*)fph; a.out = (float*)out;
  a.stash = stash; a.pool = (float*)pool;
  a.N = N; a.ns = ns; a.d_in = d_in; a.k_in = k_in; a.d_latent = d_latent;
  a.d_hidden = d_hidden; a.d_out = d_out; a.n_blocks = n_blocks; a.n_lin_z = n_lin_z;
  a.activate = activate;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_fwd<bf16>(a, s) : launch_fwd<float>(a, s);
}

// The dgrad, dtype 0 float32 (wi, wz, w0, w1 as nn.Linear keeps them), 1
// bf16 (their transposed copies).  Returns the launch's cudaError_t.
extern "C" int avr_resnetfc_dgrad_wide(const void* x, const void* g, const void* stash,
                                       const void* wi, const void* wz, const void* w0,
                                       const void* w1, const void* wo, const void* bo,
                                       const void* tables, const void* fph, void* dx, void* dz,
                                       void* cot, void* gout, void* enc, void* pool, int N, int ns,
                                       int d_in, int k_in, int d_latent, int d_hidden, int d_out,
                                       int n_blocks, int n_lin_z, int activate, int dtype,
                                       void* stream) {
  const uintptr_t aligned = (uintptr_t)stash | (uintptr_t)wi | (uintptr_t)wz | (uintptr_t)w0 |
                            (uintptr_t)w1 | (uintptr_t)cot;
  if (!shape_ok(N, ns, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z, dtype) ||
      (ns > 1 && !pool) || (aligned & 15))
    return (int)cudaErrorInvalidValue;
  FcBwdArgs a;
  a.x = (const float*)x; a.g = (const float*)g; a.stash = stash; a.wi = wi; a.wz = wz;
  a.w0 = w0; a.w1 = w1; a.wo = wo; a.bo = (const float*)bo; a.tables = (const int*)tables;
  a.fph = (const float*)fph; a.dx = (float*)dx; a.dz = dz; a.cot = cot; a.gout = gout;
  a.enc = enc; a.pool = (float*)pool; a.N = N; a.ns = ns; a.d_in = d_in; a.k_in = k_in;
  a.d_latent = d_latent; a.d_hidden = d_hidden; a.d_out = d_out; a.n_blocks = n_blocks;
  a.n_lin_z = n_lin_z; a.activate = activate;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_dgrad<bf16>(a, s) : launch_dgrad<float>(a, s);
}
