// K2's chain: the decoder's forward and dgrad as a chain of products, each
// one launch over all of a chunk's points, for the shapes whose float32
// trunk and widest operand do not fit one CTA's shared memory beside the
// other kernels' tiles, and for every wide shape past d_hidden 1,024 that
// no cluster kernel takes (ops/kernels/resnetfc.py forward_route and
// backward_route say "chain", the rule chain_takes: bf16 and float32
// d_hidden past 1,024, where the chain ran faster than the first wide
// version of csrc/resnetfc_wide.cu, and narrower d_hidden with latents too
// wide for that version's tile).
//
// Replaces, for those shapes, avr_tpu/ops/pallas/resnetfc.py:896
// fused_resnetfc (the forward, kernel call :726, stash outputs :637-653)
// and the dgrad half of its stash backward _bwd_stash_impl (:400-575, call
// :823); run per chunk as the stash forward into the chunk's workspace and
// the dgrad, the recompute backward _bwd_impl (:248-390, call :853).  The
// wgrads stay csrc/resnetfc_hopper.cu's (bf16) and csrc/resnetfc.cu's
// (float32), which take jobs of any width.
//
// What bounds it on an H100 SXM: operations (989 TFLOP/s bf16, 67 float32
// outside the tensor cores).  At the band chunk (81,920 points), 5 blocks,
// 3 injections, a latent of 1,152 and 64 encoded lanes: bf16 d_hidden
// 1,280 3.46 ms, 2,048 8.14 ms; float32 1,920 106.7 ms.  The other kernels
// keep a tile's float32 trunk (32 x d_hidden floats) and its widest operand
// in one CTA, which at these widths leaves no room for a weight stream, and
// every tile reads all the weights again (28 MB at d_hidden 1,024, 105 MB at
// 2,048 in bf16, more than L2).  Here no shared-memory wall grows with
// d_hidden or the operand width:
//   - each product is a tiled matrix product over all of a chunk's points
//     (a CTA a 128 x 128 output tile), so a weight tile is read once per
//     128 points and a product's weights (8 MB at 2,048 in bf16) stay in L2
//     while its CTAs run;
//   - the float32 trunk h (the dgrad's gh) lives in device memory, chunk x
//     d_hidden floats (ops/kernels/resnetfc.py chain_workspace), and the
//     product's epilogue adds into it: the bias, the residual add, the view
//     mean at the combine layer (the view sums in a second float32 buffer);
//   - each epilogue writes the next product's A operand, relu'd and rounded
//     to the compute dtype, straight into its stash slot (or, without the
//     stash, into one of two chunk-sized operand buffers): the A operands of
//     the chain are exactly the stash slots the wgrads read;
//   - the positional encoding is lin_in's prologue: its A tiles are computed
//     from the raw inputs as they are staged;
//   - bf16 products run on the tensor cores, mma.sync.m16n8k16 from a
//     3-stage cp.async ring of shared tiles of 64 k (8 warps, a warp 64 x 32
//     of the output); float32 products run on register-tiled FMA (no TF32:
//     8 x 8 outputs a thread, A rows and B rows from a 3-stage cp.async ring
//     of 32 k, one FMA chain per output in k order);
//   - lin_out (d_out <= 8 columns) is a warp a point.
// The dgrad is the same chain in reverse with the ReLU masks read from the
// stash in the epilogues: a head (a warp a point: lin_out's cotangent g_epi
// = g * act'(out_pre), rounded, to gout; gh = mask(relu(h_final)) * (g_epi @
// Wo)); per block c1 = round(gh) (its cotangent slot, written by the
// previous epilogue), c0 = round(mask(relu(fc_0)) * (c1 @ W1)), gh +=
// mask(relu(h)) * (c0 @ W0), which writes the next c1; the pooled cotangent
// over NS > 1 (pool = gh, then per view gh = pool / NS); per view lin_in's
// input cotangent cot_in @ Wi (float32), summed onto dx through the
// encoding's cos lanes beside the rounded encoded input enc, and dz = the
// sum over the injections j of G_j @ Wz_j as one product over the segments
// G_0 = cot_in, G_j = block j - 1's c1, rounded once.  The rounding points
// are those of the plain version (resnetfc_plain) and of chip_smoke.py
// decoder_bwd_matched.
// No float atomics and no split sums: every output has one writer and one
// order of additions, fixed by the tile and not by the chunk, so the stash
// backward is the same bits on every run and the recompute backward (the
// stash forward and the dgrad per chunk) equals it bit for bit.
//
// The host (ops/kernels/resnetfc.py chain_plan) lists a call's products as
// ChainOp records, chunk by chunk, and avr_resnetfc_chain launches them in
// order on the caller's stream.

#include "resnetfc.cuh"

namespace {

// A record of the chain (ops/kernels/resnetfc.py ChainOp mirrors it field
// for field).
struct ChainOp {
  const void* A;      // A rows (T), lda apart: segment 0
  const void* A1;     // segment j >= 1 at A1 + (j - 1) * a_seg elements
  const void* B;      // weights: bf16 [Ncols][K], float32 [K][Ncols], ldb apart; segment j at
                      // B + j * b_seg elements
  const float* bias;  // (Ncols)
  float* H;           // float32 rows ldh apart: the trunk, gh, or lin_in's input cotangent
  float* pool;        // float32 rows ldh apart: the view sum, the pooled cotangent
  void* out;          // T rows ldo apart: the next A operand, a cotangent slot, dz
  const void* mask;   // T rows ldm apart: a stash slot, its ReLU mask
  const float* x;     // the raw inputs, float32 rows d_in apart
  const int* tables;  // (2, k_tab): the encoded column's mode (0 raw, 1 sin, 2 zero), source
  const float* fph;   // (2, k_tab): frequency, phase
  const float* g;     // head: (M, d_out) output cotangent
  void* gout;         // head: (M, GOUT_W) T
  const void* wo;     // lin_out's weight (d_out, K) T
  const float* bo;    // (d_out)
  float* outf;        // lin_out: (M, d_out) float32
  float* dx;          // encoding backward: (M, d_in)
  void* enc;          // encoding backward: (M, k_tab) T
  long long a_seg, b_seg, out_view;  // out_view: elements between a boundary's views' slots
  int kind, epi, flags, M, Ncols, K, nseg, lda, ldb, ldh, ldo, ldm, d_in, k_tab, d_out, activate,
      views;
  float scale;  // 1 / NS
};

enum { OP_GEMM = 0, OP_LINOUT = 1, OP_HEAD = 2, OP_ENC = 3 };
// epilogues: lin_in (h = acc + b), an injection (h = (h + acc) + b, its
// relu(h) out), fc_0 (relu(acc + b) out), fc_1 (h = (h + acc) + b, the
// view sum or mean, relu(h) out), the dgrad's fc_1 (c0 = mask * acc out),
// its fc_0 (gh += mask * acc, round(gh) out), float32 out, T out
enum { EPI_IN = 0, EPI_Z = 1, EPI_FC0 = 2, EPI_FC1 = 3, EPI_C0 = 4, EPI_GH = 5, EPI_F32 = 6,
       EPI_T = 7 };
enum {
  F_ENCODE = 1,      // A is the positional encoding of x, computed as it is staged
  F_USE_POOL = 2,    // gh's base is pool * scale (a view's first block)
  F_BOUNDARY = 4,    // gh goes to pool, round(gh * scale) to every view's slot
  F_POOL_FIRST = 8,  // fc_1: pool = h (the first view)
  F_POOL_ADD = 16,   // fc_1: pool += h
  F_POOL_LAST = 32   // fc_1: h = (pool + h) * scale (the last view)
};

// bf16 products: 128 x 128 output tiles, k stages of 64, 3 stages, 8 warps
// (2 x 4: a warp 64 rows x 32 columns); shared rows 72 bf16 (144 bytes)
// apart, so the 8 rows of an ldmatrix hit 8 distinct bank groups.
constexpr int CH_BM = 128, CH_BN = 128, CH_BK = 64, CH_STAGES = 3, CH_THREADS = 256;
constexpr int CH_LDS = CH_BK + 8;
constexpr int CH_STAGE = (CH_BM + CH_BN) * CH_LDS;                 // bf16 a stage
constexpr int CH_SMEM = CH_STAGES * CH_STAGE * (int)sizeof(bf16);  // 110,592 bytes
// float32 products: the same tiles, k stages of 32, 3 stages; A rows of 36
// floats, B rows of 132 (a thread rows ty + 16 i, columns 4 tx + j and 64 +
// 4 tx + j)
constexpr int CF_BK = 32, CF_STAGES = 3, CF_LDA = CF_BK + 4, CF_LDB = CH_BN + 4;
constexpr int CF_STAGE = CH_BM * CF_LDA + CF_BK * CF_LDB;            // floats a stage
constexpr int CF_SMEM = CF_STAGES * CF_STAGE * (int)sizeof(float);   // 105,984 bytes
constexpr int CH_ROWS_MAX = 65535 * CH_BM;  // a chunk's points: the grid's y

__device__ __forceinline__ void cp16(void* smem, const void* gmem, bool on) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(gmem),
               "r"(on ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }

// Column j of the positional encoding of x's row r (0 past M, or for a zero
// column), as every K2 kernel computes it.
__device__ __forceinline__ float encode_val(const ChainOp& op, int r, int j) {
  const int mode = op.tables[j];
  if (r >= op.M || mode == 2) return 0.f;
  const float p = op.x[(size_t)r * op.d_in + op.tables[op.k_tab + j]];
  return mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, op.fph[j]), op.fph[op.k_tab + j]));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// gh of row r, columns c, c + 1 to where the next product reads it: the
// trunk cotangent and its rounding (the next block's c1, or cot_in); or, at
// the end of the pooled blocks (F_BOUNDARY), the pooled cotangent and every
// view's first c1, round(gh / NS).
template <typename T>
__device__ __forceinline__ void gh_store(const ChainOp& op, int r, int c, float g0, float g1) {
  T* out = static_cast<T*>(op.out) + (size_t)r * op.ldo + c;
  if (op.flags & F_BOUNDARY) {
    st2(op.pool + (size_t)r * op.ldh + c, g0, g1);
    for (int v = 0; v < op.views; ++v) st2(out + v * op.out_view, g0 * op.scale, g1 * op.scale);
  } else {
    st2(op.H + (size_t)r * op.ldh + c, g0, g1);
    st2(out, g0, g1);
  }
}

// The epilogue of columns c, c + 1 (c even) of output row r.
template <typename T>
__device__ __forceinline__ void epi_pair(const ChainOp& op, int r, int c, float a0, float a1) {
  if (r >= op.M || c >= op.Ncols) return;
  const size_t hi = (size_t)r * op.ldh + c;
  T* out = op.out ? static_cast<T*>(op.out) + (size_t)r * op.ldo + c : nullptr;
  switch (op.epi) {
    case EPI_IN: {
      const float2 b = ld2(op.bias + c);
      st2(op.H + hi, a0 + b.x, a1 + b.y);
      break;
    }
    case EPI_Z: {
      const float2 b = ld2(op.bias + c), h = ld2(op.H + hi);
      const float h0 = (h.x + a0) + b.x, h1 = (h.y + a1) + b.y;
      st2(op.H + hi, h0, h1);
      st2(out, relu(h0), relu(h1));
      break;
    }
    case EPI_FC0: {
      const float2 b = ld2(op.bias + c);
      st2(out, relu(a0 + b.x), relu(a1 + b.y));
      break;
    }
    case EPI_FC1: {
      const float2 b = ld2(op.bias + c), h = ld2(op.H + hi);
      float h0 = (h.x + a0) + b.x, h1 = (h.y + a1) + b.y;
      if (op.flags & F_POOL_FIRST) {
        st2(op.pool + hi, h0, h1);
      } else if (op.flags & F_POOL_ADD) {
        const float2 p = ld2(op.pool + hi);
        st2(op.pool + hi, p.x + h0, p.y + h1);
      } else {
        if (op.flags & F_POOL_LAST) {
          const float2 p = ld2(op.pool + hi);
          h0 = (p.x + h0) * op.scale;
          h1 = (p.y + h1) * op.scale;
        }
        st2(op.H + hi, h0, h1);
      }
      if (out) st2(out, relu(h0), relu(h1));
      break;
    }
    case EPI_C0: {
      const float2 m = ld2(static_cast<const T*>(op.mask) + (size_t)r * op.ldm + c);
      st2(out, m.x > 0.f ? a0 : 0.f, m.y > 0.f ? a1 : 0.f);
      break;
    }
    case EPI_GH: {
      float2 base;
      if (op.flags & F_USE_POOL) {
        const float2 p = ld2(op.pool + hi);
        base = make_float2(__fmul_rn(p.x, op.scale), __fmul_rn(p.y, op.scale));
      } else {
        base = ld2(op.H + hi);
      }
      const float2 m = ld2(static_cast<const T*>(op.mask) + (size_t)r * op.ldm + c);
      gh_store<T>(op, r, c, m.x > 0.f ? __fadd_rn(base.x, a0) : base.x,
                  m.y > 0.f ? __fadd_rn(base.y, a1) : base.y);
      break;
    }
    case EPI_F32:
      st2(op.H + hi, a0, a1);
      break;
    default:  // EPI_T
      st2(out, a0, a1);
  }
}

// A stage's A rows from segment seg: the encoding of x, or rows of T.
template <typename T>
__device__ __forceinline__ const T* seg_a(const ChainOp& op, int seg) {
  return seg == 0 ? static_cast<const T*>(op.A)
                  : static_cast<const T*>(op.A1) + (size_t)(seg - 1) * op.a_seg;
}

// acc = A B over the segments for the 128 x 128 tile (blockIdx.y, blockIdx.x),
// then the epilogue.  bf16: mma.sync.m16n8k16 from a 4-stage cp.async ring.
__global__ void __launch_bounds__(CH_THREADS, 2)
chain_gemm_bf16_kernel(const __grid_constant__ ChainOp op) {
  extern __shared__ __align__(128) unsigned char chain_smem[];
  bf16* sm = reinterpret_cast<bf16*>(chain_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int n0 = blockIdx.x * CH_BN, m0 = blockIdx.y * CH_BM;
  const int KT = op.nseg * op.K / CH_BK;

  auto load = [&](int kt, int s) {
    const int kg = kt * CH_BK, seg = kg / op.K, kk = kg - seg * op.K;
    bf16* a = sm + s * CH_STAGE;
    bf16* b = a + CH_BM * CH_LDS;
    if (op.flags & F_ENCODE) {
      for (int i = tid; i < CH_BM * CH_BK; i += CH_THREADS) {
        const int r = i / CH_BK, k = i - r * CH_BK;
        a[r * CH_LDS + k] = __float2bfloat16_rn(encode_val(op, m0 + r, kk + k));
      }
    } else {
      const bf16* A = seg_a<bf16>(op, seg);
      for (int i = tid; i < CH_BM * (CH_BK / 8); i += CH_THREADS) {
        const int r = i / (CH_BK / 8), kc = i % (CH_BK / 8) * 8;
        const bool on = m0 + r < op.M;
        cp16(a + r * CH_LDS + kc, on ? A + (size_t)(m0 + r) * op.lda + kk + kc : A, on);
      }
    }
    const bf16* B = static_cast<const bf16*>(op.B) + (size_t)seg * op.b_seg;
    for (int i = tid; i < CH_BN * (CH_BK / 8); i += CH_THREADS) {
      const int n = i / (CH_BK / 8), kc = i % (CH_BK / 8) * 8;
      const bool on = n0 + n < op.Ncols;
      cp16(b + n * CH_LDS + kc, on ? B + (size_t)(n0 + n) * op.ldb + kk + kc : B, on);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < CH_STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<CH_STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    if (kt + CH_STAGES - 1 < KT) load(kt + CH_STAGES - 1, (kt + CH_STAGES - 1) % CH_STAGES);
    cp_commit();
    const bf16* a = sm + (kt % CH_STAGES) * CH_STAGE;
    const bf16* b = a + CH_BM * CH_LDS;
#pragma unroll
    for (int k16 = 0; k16 < CH_BK; k16 += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(af[mt], a + (wm * 64 + mt * 16 + (lane & 15)) * CH_LDS + k16 + (lane >> 4) * 8,
                false);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t t[4];
        const int q = lane >> 3;
        ldsm_x4(t, b + (wn * 32 + np * 16 + (q >> 1) * 8 + (lane & 7)) * CH_LDS + k16 +
                       (q & 1) * 8, false);
        bf[2 * np][0] = t[0];
        bf[2 * np][1] = t[1];
        bf[2 * np + 1][0] = t[2];
        bf[2 * np + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_m16n8k16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  cp_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = m0 + wm * 64 + mt * 16 + g, c = n0 + wn * 32 + nt * 8 + 2 * t;
      epi_pair<bf16>(op, r, c, acc[mt][nt][0], acc[mt][nt][1]);
      epi_pair<bf16>(op, r + 8, c, acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// The same in float32: register-tiled FMA, a thread rows ty + 16 i (i < 8)
// and columns 4 tx + j, 64 + 4 tx + j (j < 4); one FMA chain per output in
// k order.
__global__ void __launch_bounds__(CH_THREADS, 2)
chain_gemm_f32_kernel(const __grid_constant__ ChainOp op) {
  extern __shared__ __align__(128) unsigned char chain_smem[];
  float* sm = reinterpret_cast<float*>(chain_smem);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * CH_BN, m0 = blockIdx.y * CH_BM;
  const int KT = op.nseg * op.K / CF_BK;

  auto load = [&](int kt, int s) {
    const int kg = kt * CF_BK, seg = kg / op.K, kk = kg - seg * op.K;
    float* a = sm + s * CF_STAGE;
    float* b = a + CH_BM * CF_LDA;
    if (op.flags & F_ENCODE) {
      for (int i = tid; i < CH_BM * CF_BK; i += CH_THREADS) {
        const int r = i / CF_BK, k = i - r * CF_BK;
        a[r * CF_LDA + k] = encode_val(op, m0 + r, kk + k);
      }
    } else {
      const float* A = seg_a<float>(op, seg);
      for (int i = tid; i < CH_BM * (CF_BK / 4); i += CH_THREADS) {
        const int r = i / (CF_BK / 4), kc = i % (CF_BK / 4) * 4;
        const bool on = m0 + r < op.M;
        cp16(a + r * CF_LDA + kc, on ? A + (size_t)(m0 + r) * op.lda + kk + kc : A, on);
      }
    }
    const float* B = static_cast<const float*>(op.B) + (size_t)seg * op.b_seg;
    for (int i = tid; i < CF_BK * (CH_BN / 4); i += CH_THREADS) {
      const int k = i >> 5, nc = (i & 31) * 4;
      const bool on = n0 + nc < op.Ncols;
      cp16(b + k * CF_LDB + nc, on ? B + (size_t)(kk + k) * op.ldb + n0 + nc : B, on);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < CF_STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<CF_STAGES - 2>();
    __syncthreads();
    if (kt + CF_STAGES - 1 < KT) load(kt + CF_STAGES - 1, (kt + CF_STAGES - 1) % CF_STAGES);
    cp_commit();
    const float* a = sm + (kt % CF_STAGES) * CF_STAGE;
    const float* b = a + CH_BM * CF_LDA;
#pragma unroll
    for (int k4 = 0; k4 < CF_BK; k4 += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * CF_LDA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(b + (k4 + kk) * CF_LDB + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(b + (k4 + kk) * CF_LDB + 64 + 4 * tx);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      epi_pair<float>(op, r, n0 + (j < 4 ? 0 : 64) + 4 * tx + (j & 3), acc[i][j], acc[i][j + 1]);
  }
}

// <a, w> over dh values by a whole warp (16-byte loads, lane-strided), the
// same sum on every lane in a fixed order.
template <typename T>
__device__ __forceinline__ float row_dot(const T* a, const T* w, int dh, int lane) {
  constexpr int V = Vec16<T>::N;
  float s = 0.f;
  for (int k = lane * V; k < dh; k += 32 * V) {
    float av[V], wv[V];
    load16(a + k, av);
    load16(w + k, wv);
#pragma unroll
    for (int j = 0; j < V; ++j) s = fmaf(av[j], wv[j], s);
  }
  return warp_sum(s);
}

// lin_out: out = act(A Wo^T + bo), a warp a point (A the rounded relu(h_final)).
template <typename T>
__global__ void __launch_bounds__(256) chain_linout_kernel(const __grid_constant__ ChainOp op) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= op.M) return;
  const T* a = static_cast<const T*>(op.A) + (size_t)r * op.lda;
  for (int o = 0; o < op.d_out; ++o) {
    float s = row_dot(a, static_cast<const T*>(op.wo) + (size_t)o * op.K, op.K, lane) + op.bo[o];
    if (op.activate) s = o < 3 ? sigmoidf_(s) : fmaxf(s, 0.f);
    if (lane == 0) op.outf[(size_t)r * op.d_out + o] = s;
  }
}

// The dgrad's head, a warp a point: g_epi = round(g * act'(out_pre)) to
// gout (0 past d_out; out_pre as chain_linout_kernel forms it), then gh =
// mask(relu(h_final)) * (g_epi @ Wo) to gh_store.
template <typename T>
__global__ void __launch_bounds__(256) chain_head_kernel(const __grid_constant__ ChainOp op) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= op.M) return;
  const int dh = op.K;
  const T* aout = static_cast<const T*>(op.A) + (size_t)r * op.lda;
  const T* wo = static_cast<const T*>(op.wo);
  float ge[GOUT_W];
#pragma unroll
  for (int o = 0; o < GOUT_W; ++o) {
    float gv = 0.f;
    if (o < op.d_out) {
      gv = op.g[(size_t)r * op.d_out + o];
      if (op.activate) {
        const float pre = row_dot(aout, wo + (size_t)o * dh, dh, lane) + op.bo[o];
        if (o < 3) {
          const float sg = sigmoidf_(pre);
          gv = gv * sg * (1.f - sg);
        } else if (!(pre > 0.f)) {
          gv = 0.f;
        }
      }
      gv = round_to<T>(gv);
    }
    ge[o] = gv;
    if (lane == o) static_cast<T*>(op.gout)[(size_t)r * GOUT_W + o] = from_f<T>(gv);
  }
  for (int c = 2 * lane; c < dh; c += 64) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int o = 0; o < GOUT_W; ++o) {
      if (o >= op.d_out) break;
      const float2 w = ld2(wo + (size_t)o * dh + c);
      s0 = fmaf(ge[o], w.x, s0);
      s1 = fmaf(ge[o], w.y, s1);
    }
    const float2 m = ld2(aout + c);
    gh_store<T>(op, r, c, m.x > 0.f ? s0 : 0.f, m.y > 0.f ? s1 : 0.f);
  }
}

// The encoding's backward and the encoded input: dx (a thread a raw lane)
// sums lin_in's input cotangent (H, k_tab floats a row) over the encoded
// columns of that lane in column order, a sin column through its cos; enc
// (a thread a column) is the rounded encoding, lin_in's wgrad operand.
template <typename T>
__global__ void __launch_bounds__(256) chain_enc_bwd_kernel(const __grid_constant__ ChainOp op) {
  const int kt = op.k_tab;
  const long long ndx = (long long)op.M * op.d_in, total = ndx + (long long)op.M * kt;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < ndx) {
      const int r = (int)(i / op.d_in), lane = (int)(i - (long long)r * op.d_in);
      const float p = op.x[(size_t)r * op.d_in + lane];
      float sum = 0.f;
      for (int j = 0; j < kt; ++j) {
        const int mode = op.tables[j];
        if (mode == 2 || op.tables[kt + j] != lane) continue;
        float d = op.H[(size_t)r * op.ldh + j];
        if (mode == 1)
          d = d * (cosf(__fadd_rn(__fmul_rn(p, op.fph[j]), op.fph[kt + j])) * op.fph[j]);
        sum += d;
      }
      op.dx[(size_t)r * op.d_in + lane] = sum;
    } else {
      const long long e = i - ndx;
      const int r = (int)(e / kt), j = (int)(e - (long long)r * kt);
      static_cast<T*>(op.enc)[(size_t)r * kt + j] = from_f<T>(encode_val(op, r, j));
    }
  }
}

template <typename T>
int launch_op(const ChainOp& op, cudaStream_t s) {
  constexpr bool BF = sizeof(T) == 2;
  if (op.M < 1 || op.M > CH_ROWS_MAX) return (int)cudaErrorInvalidValue;
  const unsigned warp_blocks = (unsigned)((op.M + 7) / 8);
  switch (op.kind) {
    case OP_GEMM: {
      const uintptr_t al = (uintptr_t)op.A | (uintptr_t)op.A1 | (uintptr_t)op.B;
      if (op.K < 1 || op.K % 64 || op.Ncols < 1 || op.Ncols % 64 || op.nseg < 1 || op.lda % 8 ||
          op.ldb % 8 || op.ldh % 2 || op.ldo % 2 || op.ldm % 2 || (al & 15))
        return (int)cudaErrorInvalidValue;
      const dim3 grid((unsigned)((op.Ncols + CH_BN - 1) / CH_BN),
                      (unsigned)((op.M + CH_BM - 1) / CH_BM));
      if constexpr (BF) {
        static bool set = false;  // the dynamic shared memory above 48 KB, once
        if (!set) {
          const cudaError_t e = cudaFuncSetAttribute(
              chain_gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CH_SMEM);
          if (e != cudaSuccess) return (int)e;
          set = true;
        }
        chain_gemm_bf16_kernel<<<grid, CH_THREADS, CH_SMEM, s>>>(op);
      } else {
        static bool set = false;
        if (!set) {
          const cudaError_t e = cudaFuncSetAttribute(
              chain_gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CF_SMEM);
          if (e != cudaSuccess) return (int)e;
          set = true;
        }
        chain_gemm_f32_kernel<<<grid, CH_THREADS, CF_SMEM, s>>>(op);
      }
      break;
    }
    case OP_LINOUT:
      if (op.d_out < 1 || op.d_out > GOUT_W || op.K % 64) return (int)cudaErrorInvalidValue;
      chain_linout_kernel<T><<<warp_blocks, 256, 0, s>>>(op);
      break;
    case OP_HEAD:
      if (op.d_out < 1 || op.d_out > GOUT_W || op.K % 64) return (int)cudaErrorInvalidValue;
      chain_head_kernel<T><<<warp_blocks, 256, 0, s>>>(op);
      break;
    case OP_ENC: {
      const long long total = (long long)op.M * (op.d_in + op.k_tab);
      const long long want = (total + 255) / 256;
      chain_enc_bwd_kernel<T><<<(unsigned)(want < 4096 ? want : 4096), 256, 0, s>>>(op);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The bytes of a ChainOp record: the host checks its mirror against it.
extern "C" int avr_resnetfc_chain_op_bytes() { return (int)sizeof(ChainOp); }

// Launch `n` records of the chain in order on `stream`, dtype 0 float32, 1
// bf16.  Returns the first refused or failed launch's cudaError_t (and
// launches nothing after it).
extern "C" int avr_resnetfc_chain(const void* ops, int n, int dtype, void* stream) {
  if (n < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const ChainOp* op = static_cast<const ChainOp*>(ops);
  const cudaStream_t s = (cudaStream_t)stream;
  for (int i = 0; i < n; ++i) {
    const int e = dtype == 1 ? launch_op<bf16>(op[i], s) : launch_op<float>(op[i], s);
    if (e) return e;
  }
  return 0;
}
