// K2's chain: the decoder's forward and dgrad as a chain of products, each
// one launch over all of a chunk's points, for every shape that no register
// or cluster kernel takes (ops/kernels/resnetfc.py forward_route and
// backward_route say "chain", the rule chain_takes): d_hidden past 1,024 in
// either dtype, bf16 forwards past the wgmma forward's FWD_OPERAND_MAX
// lanes, bf16 dgrads below d_hidden 256 past the dgrad tail's envelope, and
// shapes past the cluster kernels' shared memory.  The chain ran faster
// than the first versions that took some of these shapes before
// (csrc/resnetfc.cu's resnetfc_kernel, csrc/resnetfc_wide.cu's first
// version) at every corner chip_smoke.py --chain-sweep timed, and they were
// retired.
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
//   - each product is a tiled matrix product over all of a chunk's points,
//     so a weight tile is read once per tile of points and a product's
//     weights (8 MB at 2,048 in bf16) stay in L2 while its CTAs run;
//   - the float32 trunk h (the dgrad's gh) lives in device memory, chunk x
//     d_hidden floats (ops/kernels/resnetfc.py chain_workspace), and the
//     product's epilogue adds into it: the bias, the residual add, the view
//     mean at the combine layer (the view sums in a second float32 buffer);
//   - each epilogue writes the next product's A operand, relu'd and rounded
//     to the compute dtype, straight into its stash slot (or, without the
//     stash, into one of two chunk-sized operand buffers): the A operands of
//     the chain are exactly the stash slots the wgrads read;
//   - the positional encoding is a pass of its own before lin_in
//     (chain_enc_kernel, the encoded input rounded into the workspace), so
//     lin_in is an ordinary product;
//   - bf16 products run on wgmma from a TMA ring (chain_gemm_wgmma_kernel,
//     below); float32 products run on register-tiled FMA from a TMA ring,
//     A transposed to k-major in shared memory (chain_gemm_f32_kernel: no
//     TF32, one FMA chain per output in k order);
//   - lin_out (d_out <= 8 columns) is a warp a point.
// The bf16 products' own bytes: the epilogues move 10 bytes an output
// element at an injection and at fc_1 (the float32 trunk read and written,
// the bf16 next operand), 2 at fc_0, 4 at lin_in, 4 at the dgrad's fc_1 (the
// mask read, c0 written) and 12 at its fc_0 (gh read and written, the mask
// read, round(gh) written); at d_hidden 1,280 and the band chunk that is
// 9.9 GB for the forward and 2.7 GB of A reads, 3.8 ms at 3.35 TB/s, beside
// 3.46 ms of products at the bf16 peak.  A CTA's epilogue runs after its
// tile's products; what overlaps it is the producer warp, which prefetches
// a tile's float32 epilogue rows into L2 while the tile's last stages run
// and fills the ring with the next tile's stages while the epilogue runs
// (PERF.md section 6 measures the epilogues' share and the designs tried).
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

#include "hopper.cuh"
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
  F_USE_POOL = 2,    // gh's base is pool * scale (a view's first block)
  F_BOUNDARY = 4,    // gh goes to pool, round(gh * scale) to every view's slot
  F_POOL_FIRST = 8,  // fc_1: pool = h (the first view)
  F_POOL_ADD = 16,   // fc_1: pool += h
  F_POOL_LAST = 32   // fc_1: h = (pool + h) * scale (the last view)
};

// bf16 products (chain_gemm_wgmma_kernel): 128 x 256 output tiles, k
// stages of 64 in a ring of CW_STAGES, a stage an A box {64 k, 128 rows}
// (16 KB) and a B box {64 k, 256 columns} (32 KB), both 128-byte swizzled
// and 1024-byte aligned; two consumer warpgroups (a warpgroup 64 rows x 256
// columns, wgmma.m64n256k16, 128 float32 accumulators a thread) and a
// producer warp; the ring's full and empty barriers after the stages.
constexpr int CW_BM = 128, CW_BN = 256, CW_BK = 64, CW_STAGES = 4, CW_THREADS = 384;
constexpr int CW_A = CW_BM * CW_BK * 2;                 // 16,384 bytes
constexpr int CW_STAGE = CW_A + CW_BN * CW_BK * 2;      // 49,152 bytes
constexpr int CW_BAR = CW_STAGES * CW_STAGE;            // 196,608
constexpr int CW_SMEM = CW_BAR + 2 * CW_STAGES * 8;     // 196,672 bytes
constexpr int CW_EPI_GROUPS = 4;  // the epilogue's 8-column groups a thread loads before storing
// float32 products (chain_gemm_f32_kernel): 256 x 128 output tiles, k
// stages of 16.  An A box {16 k, 256 rows} lands row-major in a raw ring of
// CF_RAW slots; the producer warpgroup's other three warps transpose it into
// the stage's k-major A tile (16 rows of 256 floats, row k's 16-byte group g
// stored at group g ^ cf_swz(k)) beside the stage's B box {128 columns, 16
// k}, in a ring of CF_STAGES stages.  Eight consumer warps in 4 x 2 (a warp
// 64 x 64 outputs; a thread its warp's rows 4 r + 0..3 and 32 + 4 r + 0..3,
// r = lane / 4, and columns 4 c + 16 j + 0..3, c = lane % 4, j < 4) in two
// warpgroups and the producer warpgroup; after the rings the barriers, then
// each consumer warp's epilogue buffer (8 rows of its 64 columns, rows
// CF_EPI_LD floats apart).
constexpr int CF_BM = 256, CF_BN = 128, CF_BK = 16, CF_STAGES = 4, CF_RAW = 3, CF_THREADS = 384;
constexpr int CF_TM = 8, CF_TN = 16, CF_EPI_LD = 80;
constexpr int CF_A = CF_BM * CF_BK * (int)sizeof(float);            // 16,384 bytes: an A tile
constexpr int CF_STAGE = CF_A + CF_BK * CF_BN * (int)sizeof(float);  // 24,576 bytes
constexpr int CF_BAR = CF_STAGES * CF_STAGE + CF_RAW * CF_A;        // 147,456
constexpr int CF_EPI = CF_BAR + 2 * (CF_STAGES + CF_RAW) * 8;       // 147,568
constexpr int CF_EPI_WARP = 8 * CF_EPI_LD * (int)sizeof(float);     // 2,560 bytes
constexpr int CF_SMEM = CF_EPI + 8 * CF_EPI_WARP;                   // 168,048 bytes
constexpr int CH_ROWS_MAX = 1 << 24;  // a record's points: every grid and tile index an int

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }

// Column j of the positional encoding of x's row r (0 for a zero column),
// as every K2 kernel computes it.
__device__ __forceinline__ float encode_val(const ChainOp& op, int r, int j) {
  const int mode = op.tables[j];
  if (mode == 2) return 0.f;
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

// V consecutive values of T at p (V 2, or 4 for float: one 8- or 16-byte
// access, aligned) to floats and back.
template <int V>
__device__ __forceinline__ void ldv(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const float2 q = ld2(p);
    v[0] = q.x, v[1] = q.y;
  }
}
template <int V>
__device__ __forceinline__ void ldv(const bf16* p, float* v) {
  static_assert(V == 2, "bf16 pairs");
  const float2 q = ld2(p);
  v[0] = q.x, v[1] = q.y;
}
template <int V>
__device__ __forceinline__ void stv(float* p, const float* v) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    st2(p, v[0], v[1]);
}
template <int V>
__device__ __forceinline__ void stv(bf16* p, const float* v) {
  static_assert(V == 2, "bf16 pairs");
  st2(p, v[0], v[1]);
}

// Where the epilogue of output row r, from column c on, reads and writes:
// the bias, the float32 trunk (or gh), the view sums (or the pooled
// cotangent), the next operand (or cotangent slot, or dz) and the ReLU
// mask's stash row; columns c + j at offset j.
template <typename T>
struct EpiRow {
  const float* bias;
  float *H, *pool;
  T* out;
  const T* mask;
};

template <typename T>
__device__ __forceinline__ EpiRow<T> epi_row(const ChainOp& op, int r, int c) {
  const size_t hi = (size_t)r * op.ldh + c;
  EpiRow<T> w;
  w.bias = op.bias ? op.bias + c : nullptr;
  w.H = op.H ? op.H + hi : nullptr;
  w.pool = op.pool ? op.pool + hi : nullptr;
  w.out = op.out ? static_cast<T*>(op.out) + (size_t)r * op.ldo + c : nullptr;
  w.mask = op.mask ? static_cast<const T*>(op.mask) + (size_t)r * op.ldm + c : nullptr;
  return w;
}

// gh of columns j .. j + V - 1 of row w to where the next product reads it:
// the trunk cotangent and its rounding (the next block's c1, or cot_in); or,
// at the end of the pooled blocks (F_BOUNDARY), the pooled cotangent and
// every view's first c1, round(gh / NS).
template <typename T, int V>
__device__ __forceinline__ void gh_store(const ChainOp& op, const EpiRow<T>& w, int j,
                                         const float* g) {
  if (op.flags & F_BOUNDARY) {
    stv<V>(w.pool + j, g);
    float s[V];
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] = g[e] * op.scale;
    for (int v = 0; v < op.views; ++v) stv<V>(w.out + j + v * op.out_view, s);
  } else {
    stv<V>(w.H + j, g);
    stv<V>(w.out + j, g);
  }
}

// What the epilogue of columns j .. j + V - 1 of row w reads: the bias, the
// trunk (or gh), the view sums (or the pooled cotangent) and the mask, each
// where epilogue e (op.epi, or E where the caller knows it, E >= 0) reads
// it.  Loaded apart from the epilogue's stores, so that a caller can issue
// many groups' loads before any store.
template <int V>
struct EpiIn {
  float b[V], h[V], p[V], m[V];
};

template <typename T, int E = -1, int V = 2>
__device__ __forceinline__ EpiIn<V> epi_load(const ChainOp& op, const EpiRow<T>& w, int j) {
  EpiIn<V> in;
  const int e = E >= 0 ? E : op.epi;
  if (e == EPI_IN || e == EPI_Z || e == EPI_FC0 || e == EPI_FC1) ldv<V>(w.bias + j, in.b);
  if (e == EPI_Z || e == EPI_FC1 || (e == EPI_GH && !(op.flags & F_USE_POOL)))
    ldv<V>(w.H + j, in.h);
  if ((e == EPI_FC1 && (op.flags & (F_POOL_ADD | F_POOL_LAST))) ||
      (e == EPI_GH && (op.flags & F_USE_POOL)))
    ldv<V>(w.pool + j, in.p);
  if (e == EPI_C0 || e == EPI_GH) ldv<V>(w.mask + j, in.m);
  return in;
}

// The epilogue of columns j .. j + V - 1 (j a multiple of V) of row w on
// the products' sums a[0 .. V - 1] and what epi_load read for them; each
// value computed alone, the same way at every V.
template <typename T, int E = -1, int V = 2>
__device__ __forceinline__ void epi_store(const ChainOp& op, const EpiRow<T>& w, int j,
                                          const float* a, const EpiIn<V>& in) {
  float o[V], r[V];
  switch (E >= 0 ? E : op.epi) {
    case EPI_IN:
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = a[e] + in.b[e];
      stv<V>(w.H + j, o);
      break;
    case EPI_Z:
#pragma unroll
      for (int e = 0; e < V; ++e) {
        o[e] = (in.h[e] + a[e]) + in.b[e];
        r[e] = relu(o[e]);
      }
      stv<V>(w.H + j, o);
      stv<V>(w.out + j, r);
      break;
    case EPI_FC0:
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = relu(a[e] + in.b[e]);
      stv<V>(w.out + j, o);
      break;
    case EPI_FC1: {
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = (in.h[e] + a[e]) + in.b[e];
      if (op.flags & F_POOL_FIRST) {
        stv<V>(w.pool + j, o);
      } else if (op.flags & F_POOL_ADD) {
#pragma unroll
        for (int e = 0; e < V; ++e) r[e] = in.p[e] + o[e];
        stv<V>(w.pool + j, r);
      } else {
        if (op.flags & F_POOL_LAST) {
#pragma unroll
          for (int e = 0; e < V; ++e) o[e] = (in.p[e] + o[e]) * op.scale;
        }
        stv<V>(w.H + j, o);
      }
      if (w.out) {
#pragma unroll
        for (int e = 0; e < V; ++e) r[e] = relu(o[e]);
        stv<V>(w.out + j, r);
      }
      break;
    }
    case EPI_C0:
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = in.m[e] > 0.f ? a[e] : 0.f;
      stv<V>(w.out + j, o);
      break;
    case EPI_GH:
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float base = (op.flags & F_USE_POOL) ? __fmul_rn(in.p[e], op.scale) : in.h[e];
        o[e] = in.m[e] > 0.f ? __fadd_rn(base, a[e]) : base;
      }
      gh_store<T, V>(op, w, j, o);
      break;
    case EPI_F32:
      stv<V>(w.H + j, a);
      break;
    default:  // EPI_T
      stv<V>(w.out + j, a);
  }
}

// The bf16 products' operands as TMA tensor maps, encoded on the host from
// the record: A segment 0 (K x M, lda apart), segments 1.. (K x M x nseg -
// 1, a_seg apart), the weights' segments (K x Ncols x nseg, b_seg apart).
// Rows past M or Ncols read as zero.
struct __align__(64) ChainMaps {
  CUtensorMap a, a1, b;
};

// L2 prefetches of the float32 rows the epilogue of the tile at (m0, n0)
// will read, the trunk (or gh) or the view sums, a lane every 32 rows (the
// masks' rows as well measured slower, PERF.md section 6).
__device__ __forceinline__ void epi_prefetch(const ChainOp& op, int m0, int n0, int lane) {
  const int e = op.epi;
  const bool pool = (e == EPI_FC1 && (op.flags & (F_POOL_ADD | F_POOL_LAST))) ||
                    (e == EPI_GH && (op.flags & F_USE_POOL));
  const bool h = e == EPI_Z || e == EPI_FC1 || (e == EPI_GH && !(op.flags & F_USE_POOL));
  if (!pool && !h) return;
  const int cols = min(CW_BN, op.Ncols - n0), rows = min(CW_BM, op.M - m0);
  for (int i = lane; i < rows; i += 32) {
    const size_t hi = (size_t)(m0 + i) * op.ldh + n0;
    if (h && !((uintptr_t)(op.H + hi) & 15)) bulk_prefetch_l2(op.H + hi, cols * 4);
    if (pool && !((uintptr_t)(op.pool + hi) & 15)) bulk_prefetch_l2(op.pool + hi, cols * 4);
  }
}

// A consumer warpgroup's 64 x 256 accumulator fragment through epilogue E
// (t the thread in the warpgroup, r0 and n0 the fragment's first row and
// column): a thread's registers 4q .. 4q + 3 are columns 8q, 8q + 1 of two
// rows 8 apart, addressed from two row bases.  In groups of CW_EPI_GROUPS
// such 8-column groups, each group's loads issued before its stores (a
// load after a store waits for it: the compiler cannot tell the trunk's
// rows apart), so a group costs one round trip to L2.
template <int E>
__device__ __forceinline__ void epi_tile(const ChainOp& op, const float* acc, int r0, int n0,
                                         int t) {
  const int ra = r0 + acc_row(t, 0), cb = n0 + acc_col(t, 0);
  const EpiRow<bf16> w0 = epi_row<bf16>(op, ra, cb), w1 = epi_row<bf16>(op, ra + 8, cb);
  const bool on0 = ra < op.M, on1 = ra + 8 < op.M;
  const int nq = min(CW_BN / 8, (op.Ncols - n0) >> 3);  // 8-column groups in range
  constexpr int Q = CW_EPI_GROUPS;
#pragma unroll
  for (int q0 = 0; q0 < CW_BN / 8; q0 += Q) {
    EpiIn<2> in[2 * Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (q0 + q < nq && on0) in[2 * q] = epi_load<bf16, E>(op, w0, 8 * (q0 + q));
      if (q0 + q < nq && on1) in[2 * q + 1] = epi_load<bf16, E>(op, w1, 8 * (q0 + q));
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = 4 * (q0 + q);
      if (q0 + q < nq && on0) epi_store<bf16, E>(op, w0, 8 * (q0 + q), acc + i, in[2 * q]);
      if (q0 + q < nq && on1)
        epi_store<bf16, E>(op, w1, 8 * (q0 + q), acc + i + 2, in[2 * q + 1]);
    }
  }
}

// acc = A B over the segments, then the epilogue, for every 128 x 256 tile,
// bf16.  A persistent grid of one CTA an SM walks the tiles in order (tile
// = M block x the N tiles + N tile, a CTA every gridDim.x-th), so the CTAs
// running at once share their A blocks through L2.  Warpgroup 2's first
// warp is the producer: its lane 0 keeps CW_STAGES stages of TMA loads in
// flight across tile boundaries (the k stages run over the segments in
// order: k stage kt is segment kt * 64 / K), and at a tile's last stage the
// warp prefetches the tile's float32 epilogue rows into L2.  Warpgroups 0
// and 1 each take 64 rows of the tile: four wgmma.m64n256k16 a stage, one
// wgmma group in flight (a stage is released when the next one's products
// are issued and its own have completed), then the epilogue from the
// accumulators straight to device memory while the producer fills the ring
// with the next tile's stages.  Every output has one writer and one order of additions
// (the stages in k order, fixed by the tile), with no float atomics.
__global__ void __launch_bounds__(CW_THREADS, 1)
chain_gemm_wgmma_kernel(const __grid_constant__ ChainOp op,
                        const __grid_constant__ ChainMaps maps) {
  extern __shared__ __align__(1024) unsigned char cw_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(cw_smem + CW_BAR);
  uint64_t* empty = full + CW_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n_tiles = (op.Ncols + CW_BN - 1) / CW_BN;
  const int tiles = n_tiles * ((op.M + CW_BM - 1) / CW_BM);
  const int KT = op.nseg * op.K / CW_BK;
  if (tid == 0) {
    if (smem_u32(cw_smem) & 1023) __trap();
    for (int s = 0; s < CW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (tid >= 288) return;
    const int lane = tid & 31;
    uint32_t g = 0;  // stages issued
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * CW_BM, n0 = tile % n_tiles * CW_BN;
      for (int kt = 0; kt < KT; ++kt, ++g) {
        if (lane == 0) {
          const int st = g % CW_STAGES;
          if (g >= CW_STAGES) mbar_wait(&empty[st], (g / CW_STAGES - 1) & 1);
          const int kg = kt * CW_BK, seg = kg / op.K, kk = kg - seg * op.K;
          unsigned char* buf = cw_smem + st * CW_STAGE;
          mbar_expect_tx(&full[st], CW_STAGE);
          if (seg == 0)
            tma_load_2d(buf, &maps.a, &full[st], kk, m0);
          else
            tma_load_3d(buf, &maps.a1, &full[st], kk, m0, seg - 1);
          tma_load_3d(buf + CW_A, &maps.b, &full[st], kk, n0, seg);
        }
        __syncwarp();
        if (kt == KT - 1) epi_prefetch(op, m0, n0, lane);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int t = tid & 127;
  uint32_t g = 0;  // stages consumed
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * CW_BM, n0 = tile % n_tiles * CW_BN;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++g) {
      const int st = g % CW_STAGES;
      mbar_wait(&full[st], (g / CW_STAGES) & 1);
      const unsigned char* buf = cw_smem + st * CW_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CW_BK / 16; ++kk)
        wgmma_m64n256k16<0, 0>(acc, gmma_desc(buf + wg * (CW_A / 2) + kk * 32, 16, 1024),
                               gmma_desc(buf + CW_A + kk * 32, 16, 1024), 1);
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();
        mbar_arrive(&empty[(g - 1) % CW_STAGES]);
      }
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[(g - 1) % CW_STAGES]);
    const int r0 = m0 + wg * 64;
    switch (op.epi) {
      case EPI_IN: epi_tile<EPI_IN>(op, acc, r0, n0, t); break;
      case EPI_Z: epi_tile<EPI_Z>(op, acc, r0, n0, t); break;
      case EPI_FC0: epi_tile<EPI_FC0>(op, acc, r0, n0, t); break;
      case EPI_FC1: epi_tile<EPI_FC1>(op, acc, r0, n0, t); break;
      case EPI_C0: epi_tile<EPI_C0>(op, acc, r0, n0, t); break;
      case EPI_GH: epi_tile<EPI_GH>(op, acc, r0, n0, t); break;
      case EPI_F32: epi_tile<EPI_F32>(op, acc, r0, n0, t); break;
      default: epi_tile<EPI_T>(op, acc, r0, n0, t);
    }
  }
}

// The bf16 products' tensor maps of a record: 0 or a cudaError_t.
int chain_maps(const ChainOp& op, ChainMaps* m) {
  const uint32_t box_a[3] = {CW_BK, CW_BM, 1}, box_b[3] = {CW_BK, CW_BN, 1};
  const uint64_t K = (uint64_t)op.K, M = (uint64_t)op.M, lda = 2 * (uint64_t)op.lda,
                 ldb = 2 * (uint64_t)op.ldb;
  const uint64_t dims_a[2] = {K, M}, str_a[1] = {lda};
  int e = make_tensor_map(&m->a, op.A, 2, dims_a, str_a, box_a);
  if (!e && op.nseg > 1) {
    const uint64_t dims[3] = {K, M, (uint64_t)op.nseg - 1}, str[2] = {lda, 2 * (uint64_t)op.a_seg};
    e = make_tensor_map(&m->a1, op.A1, 3, dims, str, box_a);
  }
  if (!e) {
    const uint64_t seg = op.nseg > 1 ? 2 * (uint64_t)op.b_seg : ldb * (uint64_t)op.Ncols;
    const uint64_t dims[3] = {K, (uint64_t)op.Ncols, (uint64_t)op.nseg}, str[2] = {ldb, seg};
    e = make_tensor_map(&m->b, op.B, 3, dims, str, box_b);
  }
  return e;
}

// The float32 products' operands as TMA tensor maps, encoded on the host
// from the record as chain_maps does for bf16, unswizzled: A's boxes {16 k,
// 256 rows} (segment 0 K x M, lda apart; segments 1.. K x M x nseg - 1, a_seg
// apart); the weights' boxes {128 columns, 16 k} (Ncols x K x nseg, ldb and
// b_seg apart).  Rows past M and columns past Ncols read as zero.
int chain_maps_f32(const ChainOp& op, ChainMaps* m) {
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  const uint32_t box_a[3] = {CF_BK, CF_BM, 1}, box_b[3] = {CF_BN, CF_BK, 1};
  const uint64_t K = (uint64_t)op.K, M = (uint64_t)op.M, lda = 4 * (uint64_t)op.lda,
                 ldb = 4 * (uint64_t)op.ldb;
  const uint64_t dims_a[2] = {K, M}, str_a[1] = {lda};
  int e = make_tensor_map(&m->a, op.A, 2, dims_a, str_a, box_a, none, f32);
  if (!e && op.nseg > 1) {
    const uint64_t dims[3] = {K, M, (uint64_t)op.nseg - 1}, str[2] = {lda, 4 * (uint64_t)op.a_seg};
    e = make_tensor_map(&m->a1, op.A1, 3, dims, str, box_a, none, f32);
  }
  if (!e) {
    const uint64_t seg = op.nseg > 1 ? 4 * (uint64_t)op.b_seg : ldb * K;
    const uint64_t dims[3] = {(uint64_t)op.Ncols, K, (uint64_t)op.nseg}, str[2] = {ldb, seg};
    e = make_tensor_map(&m->b, op.B, 3, dims, str, box_b, none, f32);
  }
  return e;
}

// Where row k of a k-major A tile stores 16-byte group g: g ^ cf_swz(k), so
// that the transposing warps' stores (8 lanes: 2 row quads x the 4 k groups
// of a 16-k stage) and the consumers' loads are each conflict-free.
static_assert(CF_BK == 16, "cf_swz spreads a stage's 4 k groups");
__device__ __forceinline__ int cf_swz(int k) { return ((k >> 2) & 3) << 1; }

// A thread's row i of its warp's 64 (i < 4: 4 r + i, else 32 + 4 r + i - 4).
__device__ __forceinline__ int cf_row(int r, int i) { return (i < 4 ? 0 : 28) + 4 * r + i; }

// The float32 epilogue E of a consumer warp's 64 x 64 outputs (rows from
// row0, columns from col0), a thread's row i at a time for every thread
// through the warp's buffer ep: each thread's row i (acc[i]) into buffer row
// r, each 4-column group stored pair-swapped (the group's columns 1, 0, 3,
// 2; see the kernel), then each lane takes 4 columns of 4 of the 8 rows, two
// rows' loads before their stores, so a warp's access is 2 rows x 256
// contiguous bytes.
template <int E>
__device__ __forceinline__ void epi_f32(const ChainOp& op, const float (&acc)[CF_TM][CF_TN],
                                        float* ep, int row0, int col0, int lane) {
  const int r = lane >> 2, c = lane & 3, half = lane >> 4, col = col0 + 4 * (lane & 15);
#pragma unroll
  for (int i = 0; i < CF_TM; ++i) {
#pragma unroll
    for (int j = 0; j < CF_TN / 4; ++j)
      *reinterpret_cast<float4*>(ep + r * CF_EPI_LD + 16 * j + 4 * c) =
          make_float4(acc[i][4 * j + 1], acc[i][4 * j], acc[i][4 * j + 3], acc[i][4 * j + 2]);
    __syncwarp();
    if (col < op.Ncols) {
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        EpiIn<4> in[2];
        int rows[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          rows[u] = row0 + cf_row(2 * (q + u) + half, i);
          if (rows[u] < op.M)
            in[u] = epi_load<float, E, 4>(op, epi_row<float>(op, rows[u], col), 0);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (rows[u] >= op.M) continue;
          const float4 v = *reinterpret_cast<const float4*>(ep + (2 * (q + u) + half) * CF_EPI_LD +
                                                            4 * (lane & 15));
          const float a[4] = {v.y, v.x, v.w, v.z};
          epi_store<float, E, 4>(op, epi_row<float>(op, rows[u], col), 0, a, in[u]);
        }
      }
    }
    __syncwarp();
  }
}

// acc = A B over the segments, then the epilogue, for every 256 x 128 tile,
// float32 by FMA on the CUDA cores (no TF32, no tensor-core instruction).
//
// Replaces chain_gemm_f32_kernel's first version (PR 24: 128 x 128 tiles,
// two CTAs an SM at 128 registers a thread, 8 x 8 outputs a thread, a
// 3-stage cp.async ring that every thread filled, A read row by row), which
// ran at ~41 TFLOP/s against the cuBLAS chain's ~50.  What bounds it: the
// FMA pipe (67 TFLOP/s at 1.98 GHz; 7.15 TFLOP a call at the band chunk and
// d_hidden 1,920, 107 ms), which issues one warp instruction a cycle in each
// of an SM's four schedulers, so every instruction other than an FFMA, and
// every cycle a warp waits on a load, costs a product's slot.  What the
// design does about it:
//   - one CTA an SM, its consumer warpgroups raised to 232 registers a
//     thread (setmaxnreg; the producer warpgroup lowered to 40): 8 x 16
//     outputs a thread (128 accumulators); each k costs 128 FFMA against 2
//     LDS.128 of A and 4 of B, 24 registers, so the next k's fragments load
//     while this k's products run;
//   - A k-major in shared memory without touching device memory's layout:
//     a TMA box lands row-major, and three warps of the producer warpgroup
//     transpose it, 4 x 4 blocks from 4 LDS.128 to 4 STS.128, into the
//     stage's swizzled k-major tile; a warp's A loads then read 8 distinct
//     16-byte groups, its B loads 64 contiguous bytes: conflict-free;
//   - the copies off the consumer warps: one thread of the producer
//     warpgroup keeps the raw ring and the B boxes in flight by TMA on full
//     / empty mbarriers, across tile boundaries, so the consumers issue FFMA
//     and LDS only and the next tile's stages land during this tile's
//     epilogue;
//   - a persistent grid walking the tiles in order (an M block across all
//     its N tiles), so an M block of A and the weights stay in L2 (no
//     prefetch of the epilogue's rows, unlike the bf16 kernel: here it
//     measured slower, PERF.md section 6);
//   - register banks: an FFMA whose unreused sources share a bank waits,
//     and B lands in aligned quads; each accumulator quad is stored to the
//     epilogue buffer pair-swapped (a 16-byte store reads an aligned quad),
//     so that the allocator may keep column c's accumulator at quad
//     position c ^ 1, opposite its B value's parity (ptxas does so only in
//     part);
//   - the epilogue through that per-warp buffer, then in 16-byte groups
//     along 256 contiguous bytes of a row (epi_load / epi_store at V = 4:
//     each value computed as at V = 2).
// Measured (PERF.md section 6): 43-45 TFLOP/s by product at d_hidden 1,920,
// 1.06x the first version; the k-loop runs at ~70% of the pipe's rate with
// no spills, and the A path (its copy and transpose) costs ~5%.
// Every output is one fmaf chain from 0 over k in ascending order across
// the segments in order, as the first version computed it: the same bits.
__global__ void __launch_bounds__(CF_THREADS, 1)
chain_gemm_f32_kernel(const __grid_constant__ ChainOp op, const __grid_constant__ ChainMaps maps) {
  extern __shared__ __align__(128) unsigned char cf_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(cf_smem + CF_BAR);
  uint64_t* empty = full + CF_STAGES;
  uint64_t* raw_full = empty + CF_STAGES;
  uint64_t* raw_empty = raw_full + CF_RAW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (op.Ncols + CF_BN - 1) / CF_BN;
  const int tiles = n_tiles * ((op.M + CF_BM - 1) / CF_BM);
  const int KT = op.nseg * op.K / CF_BK;
  if (tid == 0) {
    if (smem_u32(cf_smem) & 127) __trap();  // the TMA boxes' 128-byte alignment
    for (int s = 0; s < CF_STAGES; ++s) {
      mbar_init(&full[s], 1 + 96);  // the B box's bytes and the three transposing warps
      mbar_init(&empty[s], 256);
    }
    for (int s = 0; s < CF_RAW; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], 96);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    if (warp == 8 && lane > 0) return;
    uint32_t g = 0;  // stages issued
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * CF_BM, n0 = tile % n_tiles * CF_BN;
      for (int kt = 0; kt < KT; ++kt, ++g) {
        const int st = g % CF_STAGES, rs = g % CF_RAW;
        unsigned char* raw = cf_smem + CF_STAGES * CF_STAGE + rs * CF_A;
        if (warp == 8) {  // the copies, by TMA from one thread
          const int kg = kt * CF_BK, seg = kg / op.K, kk = kg - seg * op.K;
          if (g >= CF_RAW) mbar_wait(&raw_empty[rs], (g / CF_RAW - 1) & 1);
          mbar_expect_tx(&raw_full[rs], CF_A);
          if (seg == 0)
            tma_load_2d(raw, &maps.a, &raw_full[rs], kk, m0);
          else
            tma_load_3d(raw, &maps.a1, &raw_full[rs], kk, m0, seg - 1);
          if (g >= CF_STAGES) mbar_wait(&empty[st], (g / CF_STAGES - 1) & 1);
          mbar_expect_tx(&full[st], CF_STAGE - CF_A);
          tma_load_3d(cf_smem + st * CF_STAGE + CF_A, &maps.b, &full[st], n0, kk, seg);
          continue;
        }
        // the transpose: 4 x 4 blocks (rows 4 b / 4 .. + 3, k 4 (b % 4) .. + 3)
        const int t = tid - 288;
        const float* ra = reinterpret_cast<const float*>(raw);
        float* at = reinterpret_cast<float*>(cf_smem + st * CF_STAGE);
        mbar_wait(&raw_full[rs], (g / CF_RAW) & 1);
        if (g >= CF_STAGES) mbar_wait(&empty[st], (g / CF_STAGES - 1) & 1);
        for (int b = t; b < CF_BM / 4 * (CF_BK / 4); b += 96) {
          const int rq = b / (CF_BK / 4), c = b % (CF_BK / 4);
          float4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = *reinterpret_cast<const float4*>(ra + (4 * rq + u) * CF_BK + 4 * c);
          float4* o = reinterpret_cast<float4*>(at + 4 * c * CF_BM + ((rq ^ cf_swz(4 * c)) << 2));
          o[0] = make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
          o[CF_BM / 4] = make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
          o[CF_BM / 2] = make_float4(v[0].z, v[1].z, v[2].z, v[3].z);
          o[3 * CF_BM / 4] = make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
        }
        mbar_arrive(&raw_empty[rs]);
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // a consumer: rows r (4 r + 0..3, 32 + 4 r + 0..3), column group c (4
  // groups of 4 columns 16 apart) of warp (wm, wn)'s 64 x 64 outputs
  setmaxnreg_inc<232>();
  const int r = lane >> 2, c = lane & 3, wm = warp >> 1, wn = warp & 1;
  const int g0 = wm * 16 + r, g1 = g0 + 8;  // the thread's two 16-byte A groups a k row
  uint32_t g = 0;  // stages consumed
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * CF_BM, n0 = tile % n_tiles * CF_BN;
    float acc[CF_TM][CF_TN];
#pragma unroll
    for (int i = 0; i < CF_TM; ++i)
#pragma unroll
      for (int j = 0; j < CF_TN; ++j) acc[i][j] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++g) {
      const int st = g % CF_STAGES;
      mbar_wait(&full[st], (g / CF_STAGES) & 1);
      const float* at = reinterpret_cast<const float*>(cf_smem + st * CF_STAGE);
      const float* bs = reinterpret_cast<const float*>(cf_smem + st * CF_STAGE + CF_A) +
                        wn * 64 + 4 * c;
#pragma unroll 8
      for (int k = 0; k < CF_BK; ++k) {
        const int sw = cf_swz(k);
        const float4 a0 = *reinterpret_cast<const float4*>(at + k * CF_BM + ((g0 ^ sw) << 2));
        const float4 a1 = *reinterpret_cast<const float4*>(at + k * CF_BM + ((g1 ^ sw) << 2));
        const float av[CF_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[CF_TN];
#pragma unroll
        for (int j = 0; j < CF_TN / 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(bs + k * CF_BN + 16 * j);
          bv[4 * j] = v.x, bv[4 * j + 1] = v.y, bv[4 * j + 2] = v.z, bv[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < CF_TM; ++i)
#pragma unroll
          for (int j = 0; j < CF_TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      mbar_arrive(&empty[st]);
    }
    const int row0 = m0 + wm * 64, col0 = n0 + wn * 64;
    float* ep = reinterpret_cast<float*>(cf_smem + CF_EPI + warp * CF_EPI_WARP);
    switch (op.epi) {
      case EPI_IN: epi_f32<EPI_IN>(op, acc, ep, row0, col0, lane); break;
      case EPI_Z: epi_f32<EPI_Z>(op, acc, ep, row0, col0, lane); break;
      case EPI_FC0: epi_f32<EPI_FC0>(op, acc, ep, row0, col0, lane); break;
      case EPI_FC1: epi_f32<EPI_FC1>(op, acc, ep, row0, col0, lane); break;
      case EPI_C0: epi_f32<EPI_C0>(op, acc, ep, row0, col0, lane); break;
      case EPI_GH: epi_f32<EPI_GH>(op, acc, ep, row0, col0, lane); break;
      case EPI_F32: epi_f32<EPI_F32>(op, acc, ep, row0, col0, lane); break;
      default: epi_f32<EPI_T>(op, acc, ep, row0, col0, lane);
    }
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
  const EpiRow<T> w = epi_row<T>(op, r, 0);
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
    const float gv[2] = {m.x > 0.f ? s0 : 0.f, m.y > 0.f ? s1 : 0.f};
    gh_store<T, 2>(op, w, c, gv);
  }
}

// The encoded input and, in the dgrad, the encoding's backward: enc (a
// thread a column) is the rounded encoding, lin_in's A operand in the
// forward and its wgrad operand in the dgrad; dx (where the record has
// one; a thread a raw lane) sums lin_in's input cotangent (H, k_tab floats
// a row) over the encoded columns of that lane in column order, a sin
// column through its cos.
template <typename T>
__global__ void __launch_bounds__(256) chain_enc_kernel(const __grid_constant__ ChainOp op) {
  const int kt = op.k_tab;
  const long long ndx = op.dx ? (long long)op.M * op.d_in : 0, total = ndx + (long long)op.M * kt;
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

// The persistent grid of a product's bm x bn tiles: a CTA an SM, at most a
// tile each.  0 or a cudaError_t.
int persistent_grid(const ChainOp& op, int bm, int bn, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t c;
  if ((c = cudaGetDevice(&dev)) != cudaSuccess ||
      (c = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)c;
  const int tiles = ((op.Ncols + bn - 1) / bn) * ((op.M + bm - 1) / bm);
  *grid = tiles < sms ? tiles : sms;
  return 0;
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
      if constexpr (BF) {
        // the tensor maps' strides: multiples of 16 bytes
        if (op.nseg > 1 && (op.a_seg % 8 || op.b_seg % 8)) return (int)cudaErrorInvalidValue;
        static bool set = false;  // the dynamic shared memory above 48 KB, once
        if (!set) {
          const cudaError_t e = cudaFuncSetAttribute(
              chain_gemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CW_SMEM);
          if (e != cudaSuccess) return (int)e;
          set = true;
        }
        ChainMaps maps;
        int grid = 0, e = chain_maps(op, &maps);
        if (e || (e = persistent_grid(op, CW_BM, CW_BN, &grid))) return e;
        chain_gemm_wgmma_kernel<<<grid, CW_THREADS, CW_SMEM, s>>>(op, maps);
      } else {
        // the epilogue's 16-byte groups, the tensor maps' segment strides
        const uintptr_t ep = (uintptr_t)op.bias | (uintptr_t)op.H | (uintptr_t)op.pool |
                             (uintptr_t)op.out | (uintptr_t)op.mask;
        if ((ep & 15) || op.ldh % 4 || op.ldo % 4 || op.ldm % 4 || op.out_view % 4 ||
            (op.nseg > 1 && (op.a_seg % 4 || op.b_seg % 4)))
          return (int)cudaErrorInvalidValue;
        static bool set = false;
        if (!set) {
          const cudaError_t e = cudaFuncSetAttribute(
              chain_gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CF_SMEM);
          if (e != cudaSuccess) return (int)e;
          set = true;
        }
        ChainMaps maps;
        int grid = 0, e = chain_maps_f32(op, &maps);
        if (e || (e = persistent_grid(op, CF_BM, CF_BN, &grid))) return e;
        chain_gemm_f32_kernel<<<grid, CF_THREADS, CF_SMEM, s>>>(op, maps);
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
      const long long total = (long long)op.M * ((op.dx ? op.d_in : 0) + op.k_tab);
      const long long want = (total + 255) / 256;
      chain_enc_kernel<T><<<(unsigned)(want < 4096 ? want : 4096), 256, 0, s>>>(op);
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
