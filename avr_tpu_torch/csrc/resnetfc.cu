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
// The float32 forward (resnetfc_fwd_f32_kernel, below): register-tiled FMA
// products with every weight slab staged in shared memory by bulk copies.
// bf16 forwards are csrc/resnetfc_hopper.cu's (wgmma), csrc/resnetfc_wide.cu's
// (the TMA cluster kernel) and csrc/resnetfc_chain.cu's (past both), as
// ops/kernels/resnetfc.py forward_route decides.
//
// Stash backward, float32 operands (the JAX CLI's default dtype; the bf16
// backward is csrc/resnetfc_hopper.cu's, on wgmma and TMA).  The dgrad
// kernel (resnetfc_dgrad_f32_kernel, below the forward) walks a 32-point
// tile's chain in reverse with the float32 forward's design: register-tiled
// FMA products over the untransposed weights' 16-row slabs, streamed
// through a shared ring by bulk copies; a block product's ReLU mask (its
// stash slot's tile rows) is prefetched into L2 with the product's first
// slab and read by each thread when the product ends; it writes every
// product's output cotangent (what the TPU
// kernel feeds its wgrad) from registers, and ends in dz and dx (the
// encoding's cos lanes summed back onto the raw lanes).  The wgrad kernel
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

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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
// float32 dgrad (resnetfc_dgrad_f32_kernel): each 32-point tile's chain
// walked in reverse with the float32 forward's design.
//
// Per tile: lin_out's cotangent g_epi = g * act'(out_pre) (written to
// gout) and the trunk cotangent gh = mask(relu(h_final)) * (g_epi @ Wo);
// the pooled blocks; then per view (gh the pooled cotangent / NS) its
// blocks, each injection's latent cotangent dz += G_k @ Wz_k (G_k the trunk
// cotangent after block k), and lin_in's, the encoding's cotangent G_0 @
// Wi, summed back onto the raw lanes (dx: the sin lanes carry cos(t) f).  A
// block's backward: cot1 = gh; c0 = mask(relu(fc_0)) * (gh @ W1); gh +=
// mask(relu(h)) * (c0 @ W0).  Every product's A operand (its output
// cotangent) goes to cot, the encoded input to enc: what the wgrad reads.
//
// Every product has K = d_hidden: the rows of an nn.Linear weight as it is
// (out, in), so a slab of F32_KS rows is one contiguous block (a latent or
// lin_in column chunk: one bulk copy a row).  The tile's slabs stream, in
// the order the reverse chain takes them (dg_product), through the
// forward's ring: F32_STAGES stages, a full and an empty mbarrier each, the
// warps taking turns to issue slab j F32_AHEAD ahead of the one being
// multiplied.  d_hidden / 2 threads own 8 points x 8 columns of a
// d_hidden-wide product (the forward's layout), so gh and the accumulators
// stay in registers; the A operand (gh, or the masked c0) is a shared tile
// of 32 rows of d_hidden + 4 floats.  The ReLU masks: a block product's
// first slab also prefetches the tile's 32 rows of its stash slot into L2
// (one bulk prefetch, waited on by nothing), and when the product ends each
// thread reads its own 8 x 8 values from there (L2 hits, once a product:
// folding rows into bit masks inside the slab loop slows every slab).
// Cotangents go to cot from registers (16-byte stores, waited on by
// nothing).  The tile's start (g_epi and gh) loops over the tile rather
// than unrolling: code run once a tile, unrolled, spends its time fetching
// instructions.  Narrow products (lin_in in F32_IN_W-column
// chunks, a latent chunk narrower than d_hidden) take fewer points a thread
// (dg_mode), so every warp still works.  dz: each injection's product
// read-modify-writes the thread's own dz rows, k descending from 0.f, and dx
// its own (point, lane) sums, chunk by chunk in j order.  Each output is
// then the same float32 FMA chain, in k order, as in the first port's
// dgrad, and dx, dz, cot, gout and enc are its bits.  No float atomics.
// Bound on H100: operations (6.88 MFLOP a point at d_hidden 512, 5 blocks,
// 3 injections, a latent of 512: 2.25 TFLOP at 327,680 points, 33.6 ms at
// 67 TFLOP/s); its stash reads and cotangent writes, 45 KB a point, take
// 4.4 ms at 3.35 TB/s and run under the products.
// ---------------------------------------------------------------------------

constexpr int F32_IN_W = 64;           // columns of a lin_in chunk
constexpr int F32_ELD = F32_IN_W + 4;  // row stride (floats) of its shared output

// shared memory: the ring (each stage a slab of at most d_hidden columns),
// the A tile, lin_in's output chunk, g_epi, the barriers
__host__ __device__ inline int dg_stage_floats(int dh) { return F32_KS * dh; }
__host__ __device__ inline size_t dg_smem_bytes(int dh) {
  return 4 * ((size_t)F32_STAGES * dg_stage_floats(dh) + (size_t)F32_TM * (dh + 4) +
              F32_TM * F32_ELD + F32_TM * GOUT_W) +
         16 * F32_STAGES;
}
// Points a thread takes in a product cw columns wide (8, 4, 2 or 1): the
// most that still keeps the d_hidden / 2 threads' 8-column groups within
// its 32 x cw outputs.
__host__ __device__ inline int dg_mode(int cw, int dh) {
  int p = 1;
  while (p < 8 && p * dh < 8 * cw) p *= 2;
  return p;
}

enum { DG_W1, DG_W0, DG_WZ, DG_WI };

struct DgProduct {
  int kind, k, v, cb, cw;  // weight, block, view, first column, columns
};

__device__ __forceinline__ int dg_latent_chunks(const FcBwdArgs& a) {
  return (a.d_latent + a.d_hidden - 1) / a.d_hidden;
}
__device__ __forceinline__ int dg_products(const FcBwdArgs& a) {
  return 2 * (a.n_blocks - a.n_lin_z) +
         a.ns * (a.n_lin_z * (2 + dg_latent_chunks(a)) + a.k_in / F32_IN_W);
}

// Product p of the tile's reverse chain: the pooled blocks (k = n_blocks -
// 1 down to n_lin_z, W1 then W0), then per view, for k = n_lin_z - 1 down
// to 0, block k's W1 and W0 and injection k's latent product in column
// chunks of at most d_hidden, then lin_in in chunks of F32_IN_W columns.
__device__ __forceinline__ DgProduct dg_product(const FcBwdArgs& a, int p) {
  const int dh = a.d_hidden, nlz = a.n_lin_z, pooled = 2 * (a.n_blocks - nlz);
  const int per_block = 2 + dg_latent_chunks(a), per_view = nlz * per_block + a.k_in / F32_IN_W;
  DgProduct q;
  if (p < pooled) {
    q.kind = p & 1 ? DG_W0 : DG_W1;
    q.k = a.n_blocks - 1 - p / 2;
    q.v = 0;
    q.cb = 0;
    q.cw = dh;
    return q;
  }
  p -= pooled;
  q.v = p / per_view;
  const int r = p - q.v * per_view;
  if (r < nlz * per_block) {
    const int t = r % per_block;
    q.k = nlz - 1 - r / per_block;
    q.kind = t == 0 ? DG_W1 : t == 1 ? DG_W0 : DG_WZ;
    q.cb = t < 2 ? 0 : (t - 2) * dh;
    q.cw = t < 2 ? dh : min(dh, a.d_latent - q.cb);
  } else {
    q.kind = DG_WI;
    q.k = 0;
    q.cb = (r - nlz * per_block) * F32_IN_W;
    q.cw = F32_IN_W;
  }
  return q;
}

struct DgPipe {
  float* base;       // stage s at base + s * stage
  int stage;         // floats a stage
  uint64_t* full;    // arrival of a stage's slab
  uint64_t* empty;   // its release by every warp
  int i;             // the next slab to multiply
  int total;         // slabs of the tile
  int r0;            // the tile's first point
  int warps;         // the CTA's warps: slab j is issued by warp j % warps
  int qp;            // the product this thread last issued a slab of, decoded in q
  DgProduct q;
};

// Slab j into its stage, by its warp, once every warp has released the
// stage's previous slab (j - F32_STAGES): the weight rows (one bulk copy,
// or one a row of a column chunk), completing on the stage's full barrier.
// With a block product's first slab, the tile's rows of its stash slot
// (the product's ReLU mask, read when it ends) are prefetched into L2.
__device__ __forceinline__ void dg_issue(const FcBwdArgs& a, DgPipe& p, int j) {
  const int lane = threadIdx.x & 31, dh = a.d_hidden, spp = dh / F32_KS;
  const int prod = j / spp, st = j % F32_STAGES, s = j - prod * spp;
  if (prod != p.qp) {  // a warp issues every warps-th slab: it decodes each product once
    p.q = dg_product(a, prod);
    p.qp = prod;
  }
  const DgProduct& q = p.q;
  const float* w;
  int ld = dh;
  switch (q.kind) {
    case DG_W1: w = static_cast<const float*>(a.w1) + (size_t)q.k * dh * dh; break;
    case DG_W0: w = static_cast<const float*>(a.w0) + (size_t)q.k * dh * dh; break;
    case DG_WZ:
      ld = a.d_latent;
      w = static_cast<const float*>(a.wz) + (size_t)q.k * dh * ld;
      break;
    default:
      ld = a.k_in;
      w = static_cast<const float*>(a.wi);
      break;
  }
  w += (size_t)s * F32_KS * ld + q.cb;
  if (j >= F32_STAGES) mbar_wait(&p.empty[st], (uint32_t)(j / F32_STAGES - 1) & 1u);
  float* dst = p.base + (size_t)st * p.stage;
  const uint32_t wbytes = (uint32_t)(F32_KS * q.cw * 4);
  if (lane == 0) mbar_expect_tx(&p.full[st], wbytes);
  __syncwarp();
  if (q.cw == ld) {
    if (lane == 0) bulk_load(dst, w, wbytes, &p.full[st]);
  } else if (lane < F32_KS) {
    bulk_load(dst + lane * q.cw, w + (size_t)lane * ld, (uint32_t)(q.cw * 4), &p.full[st]);
  }
  if (lane == F32_KS && s == 0 && q.kind <= DG_W0) {
    const size_t slot = stash_slot(q.k, q.kind == DG_W1 ? 1 : 0, q.v, a.ns, a.n_lin_z);
    bulk_prefetch_l2(static_cast<const float*>(a.stash) + (slot * a.N + p.r0) * dh,
                     (uint32_t)(min(F32_TM, a.N - p.r0) * dh * 4));
  }
}

// A thread's role in a product cw columns wide at P points a thread
// (dg_mode): points tp + (32 / P) i (i < P), columns c0 = 4 tc + {0..3}
// and c1 = cw / 2 + 4 tc + {0..3}.  A warp is 4 (tp) x 8 (tc): its 16-byte
// reads of the A tile hit 4 rows (4 bank groups), of a slab row 128
// contiguous bytes.  At P = 8 and cw = d_hidden: the forward's layout.
// Returns whether the thread has outputs.
template <int P>
__device__ __forceinline__ bool dg_role(int cw, int& tp, int& c0, int& c1) {
  constexpr int WR = 8 / P;  // warps along the points
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tc = 8 * (warp / WR) + (lane & 7);
  tp = (lane >> 3) + 4 * (warp % WR);
  c0 = 4 * tc;
  c1 = cw / 2 + 4 * tc;
  return warp < WR * (cw / 64);
}

// acc += A (32 points x F32_KS k) W (F32_KS x cw) for this thread's P x 8
// outputs; A rows lda floats apart, W rows ldw.
template <int P>
__device__ __forceinline__ void dg_fma_slab(const float* A, int lda, const float* W, int ldw,
                                            int tp, int c0, int c1, float (&acc)[8][8]) {
  constexpr int R = 32 / P;
#pragma unroll
  for (int k4 = 0; k4 < F32_KS; k4 += 4) {
    float4 av[P];
#pragma unroll
    for (int i = 0; i < P; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (tp + R * i) * lda + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(W + (k4 + kk) * ldw + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(W + (k4 + kk) * ldw + c1);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
      }
    }
  }
}

// acc = the next product (its d_hidden / F32_KS slabs of the pipe, cw
// columns, A from the shared tile As) at P points a thread; threads with no
// outputs only keep the pipe's turns.  The slab F32_AHEAD ahead is issued
// first, by its warp.
template <int P>
__device__ __forceinline__ void dg_consume(const FcBwdArgs& a, DgPipe& p, const float* As, int lda,
                                           int cw, float (&acc)[8][8]) {
  const int dh = a.d_hidden, spp = dh / F32_KS, warp = threadIdx.x >> 5;
  int tp, c0, c1;
  const bool on = dg_role<P>(cw, tp, c0, c1);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < spp; ++s, ++p.i) {
    const int j = p.i + F32_AHEAD;
    if (j < p.total && j % p.warps == warp) dg_issue(a, p, j);
    const int st = p.i % F32_STAGES;
    mbar_wait(&p.full[st], (uint32_t)(p.i / F32_STAGES) & 1u);
    const float* W = p.base + (size_t)st * p.stage;
    if (on) dg_fma_slab<P>(As + s * F32_KS, lda, W, cw, tp, c0, c1, acc);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&p.empty[st]);
  }
}

// The ReLU mask of a block product's output: m[i][j] = the stash slot's
// value at this thread's point tp + 4 i and column j of c0..c0 + 3, c1..c1
// + 3 (0 past N); the slot's tile rows are L2-hot (dg_issue prefetched them
// with the product's first slab).
__device__ __forceinline__ void dg_mask(const float* slot, int tp, int c0, int c1, int r0, int N,
                                        int dh, float (&m)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + tp + 4 * i;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f), t = u;
    if (row < N) {
      u = __ldg(reinterpret_cast<const float4*>(slot + (size_t)row * dh + c0));
      t = __ldg(reinterpret_cast<const float4*>(slot + (size_t)row * dh + c1));
    }
    m[i][0] = u.x; m[i][1] = u.y; m[i][2] = u.z; m[i][3] = u.w;
    m[i][4] = t.x; m[i][5] = t.y; m[i][6] = t.z; m[i][7] = t.w;
  }
}

// v (a d_hidden-wide product's P = 8 outputs) into the A tile and to the
// cotangent slot dst (rows below N)
__device__ __forceinline__ void dg_store(float* As, int lda, int tp, int c0, int c1,
                                         const float (&v)[8][8], float* dst, int r0, int N,
                                         int dh) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tp + 4 * i;
    const float4 x = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    const float4 y = make_float4(v[i][4], v[i][5], v[i][6], v[i][7]);
    *reinterpret_cast<float4*>(As + r * lda + c0) = x;
    *reinterpret_cast<float4*>(As + r * lda + c1) = y;
    if (r0 + r < N) {
      float* row = dst + (size_t)(r0 + r) * dh;
      *reinterpret_cast<float4*>(row + c0) = x;
      *reinterpret_cast<float4*>(row + c1) = y;
    }
  }
}

// The epilogue of a latent or lin_in product (P points a thread, cw
// columns from cb), after it: a latent chunk read-modify-writes the
// thread's own dz rows (from 0.f for the first injection, k = n_lin_z - 1,
// so dz sums the injections k descending); a lin_in chunk goes through the
// shared Es onto dx, each (point, raw lane) sum read back from dx after the
// first chunk and adding the chunk's columns in order, and after the last
// chunk the encoded input goes to enc.
template <int P>
__device__ __forceinline__ void dg_narrow(const FcBwdArgs& a, DgPipe& p, const float* As, int lda,
                                          float* Es, const DgProduct& q, float (&acc)[8][8]) {
  dg_consume<P>(a, p, As, lda, q.cw, acc);
  constexpr int R = 32 / P;
  int tp, c0, c1;
  const bool on = dg_role<P>(q.cw, tp, c0, c1);
  const int N = a.N, r0 = p.r0;
  if (q.kind == DG_WZ) {
    if (!on) return;
    const bool first = q.k == a.n_lin_z - 1;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int row = r0 + tp + R * i;
      if (row >= N) continue;
      float* d = static_cast<float*>(a.dz) + ((size_t)q.v * N + row) * a.d_latent + q.cb;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4* o = reinterpret_cast<float4*>(d + (h ? c1 : c0));
        float4 x = first ? make_float4(0.f, 0.f, 0.f, 0.f) : *o;
        x.x = x.x + acc[i][4 * h];
        x.y = x.y + acc[i][4 * h + 1];
        x.z = x.z + acc[i][4 * h + 2];
        x.w = x.w + acc[i][4 * h + 3];
        *o = x;
      }
    }
    return;
  }
  __syncthreads();  // the previous chunk's sums are done with Es
  if (on) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float* e = Es + (tp + R * i) * F32_ELD;
      *reinterpret_cast<float4*>(e + c0) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(e + c1) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();
  const int d_in = a.d_in, k_in = a.k_in;
  for (int idx = threadIdx.x; idx < F32_TM * d_in; idx += blockDim.x) {
    const int r = idx / d_in, lane = idx - r * d_in, row = r0 + r;
    if (row >= N) continue;
    const size_t at = ((size_t)q.v * N + row) * d_in + lane;
    const float x = a.x[at];
    float sum = q.cb == 0 ? 0.f : a.dx[at];
    for (int jj = 0; jj < F32_IN_W; ++jj) {
      const int j = q.cb + jj, mode = a.tables[j];
      if (mode == 2 || a.tables[k_in + j] != lane) continue;
      float d = Es[r * F32_ELD + jj];
      if (mode == 1) d = d * (cosf(__fadd_rn(__fmul_rn(x, a.fph[j]), a.fph[k_in + j])) * a.fph[j]);
      sum += d;
    }
    a.dx[at] = sum;
  }
  if (q.cb + F32_IN_W < k_in) return;
  float* enc = static_cast<float*>(a.enc) + (size_t)q.v * N * k_in;
  for (int idx = threadIdx.x; idx < F32_TM * k_in; idx += blockDim.x) {
    const int r = idx / k_in, j = idx - r * k_in, row = r0 + r;
    if (row >= N) continue;
    const int mode = a.tables[j];
    float val = 0.f;
    if (mode != 2) {
      const float x = a.x[((size_t)q.v * N + row) * d_in + a.tables[k_in + j]];
      val = mode == 0 ? x : sinf(__fadd_rn(__fmul_rn(x, a.fph[j]), a.fph[k_in + j]));
    }
    enc[(size_t)row * k_in + j] = val;
  }
}

// gh (this thread's 8 x 8) into the A tile and to cotangent slot cs, between
// barriers
__device__ __forceinline__ void dg_entry(float* As, int lda, int tp, int c0, int c1,
                                         const float (&gh)[8][8], float* cot, int cs, int r0,
                                         int N, int dh) {
  __syncthreads();  // every thread is done reading the A tile
  dg_store(As, lda, tp, c0, c1, gh, cot + (size_t)cs * N * dh, r0, N, dh);
  __syncthreads();
}

// a.wi, wz, w0, w1: nn.Linear layout, (dh, k_in), (n_lin_z, dh, dl) and
// (n_blocks, dh, dh) twice; a.pool: NS > 1, 32 x dh floats a tile.
// d_hidden / 2 threads (at 512, eight warps: one CTA an SM, up to 255
// registers a thread).
__global__ void __launch_bounds__(256, 1)
resnetfc_dgrad_f32_kernel(const __grid_constant__ FcBwdArgs a) {
  extern __shared__ __align__(128) float dg_smem[];
  const int dh = a.d_hidden, nc = blockDim.x, N = a.N, ns = a.ns, nb = a.n_blocks;
  const int nlz = a.n_lin_z, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  DgPipe p;
  p.stage = dg_stage_floats(dh);
  p.base = dg_smem;
  float* As = dg_smem + (size_t)F32_STAGES * p.stage;
  const int lda = dh + 4;
  float* Es = As + F32_TM * lda;      // lin_in's output chunk
  float* gs = Es + F32_TM * F32_ELD;  // g_epi
  p.full = reinterpret_cast<uint64_t*>(gs + F32_TM * GOUT_W);
  p.empty = p.full + F32_STAGES;
  p.i = 0;
  const int products = dg_products(a);
  p.total = products * (dh / F32_KS);
  p.r0 = blockIdx.x * F32_TM;
  p.warps = nc / 32;
  p.qp = -1;
  if (tid == 0) {
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(&p.full[s], 1);
      mbar_init(&p.empty[s], nc / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  for (int j = 0; j < F32_AHEAD && j < p.total; ++j)
    if (j % p.warps == warp) dg_issue(a, p, j);
  // this thread's points tp + 4 i and columns of a d_hidden-wide product
  const int r0 = p.r0, tp = lane >> 3, tc = warp * 8 + (lane & 7), c0 = 4 * tc, c1 = nc + 4 * tc;
  const size_t slot = (size_t)N * dh;
  float* cot = static_cast<float*>(a.cot);
  const float* wo = static_cast<const float*>(a.wo);
  float gh[8][8], acc[8][8];

  // lin_out: relu(h_final) into the A tile; g_epi = g * act'(out_pre); gh =
  // mask(relu(h_final)) * (g_epi @ Wo)
  const float* aout = static_cast<const float*>(a.stash) +
                      (size_t)(stash_slots(ns, nb, nlz) - 1) * slot;
  for (int idx = tid; idx < F32_TM * (dh / 4); idx += nc) {
    const int r = idx / (dh / 4), cv = idx - r * (dh / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < N) val = __ldg(reinterpret_cast<const float4*>(aout + (size_t)(r0 + r) * dh) + cv);
    *reinterpret_cast<float4*>(As + r * lda + 4 * cv) = val;
  }
  __syncthreads();
  for (int idx = tid; idx < F32_TM * GOUT_W; idx += nc) {
    const int r = idx / GOUT_W, o = idx - r * GOUT_W, row = r0 + r;
    float gv = 0.f;
    if (row < N && o < a.d_out) {
      gv = a.g[(size_t)row * a.d_out + o];
      if (a.activate) {
        const float* arow = As + r * lda;
        const float* wrow = wo + (size_t)o * dh;
        float sum = 0.f;
        for (int k = 0; k < dh; ++k) sum = fmaf(arow[k], wrow[k], sum);
        const float pre = sum + a.bo[o];
        if (o < 3) {
          const float sg = sigmoidf_(pre);
          gv = gv * sg * (1.f - sg);
        } else if (!(pre > 0.f)) {
          gv = 0.f;
        }
      }
    }
    gs[idx] = gv;
    if (row < N) static_cast<float*>(a.gout)[(size_t)row * GOUT_W + o] = gv;
  }
  __syncthreads();
  // gh in place of relu(h_final) in the A tile, by a loop over the tile
  // (once a tile: unrolled, it would spend its time on instruction fetch),
  // then each thread's own 8 x 8 into registers
  for (int idx = tid; idx < F32_TM * dh; idx += nc) {
    const int r = idx / dh, c = idx - r * dh;
    float sum = 0.f;
    for (int o = 0; o < a.d_out; ++o) sum = fmaf(gs[r * GOUT_W + o], wo[(size_t)o * dh + c], sum);
    float& h = As[r * lda + c];
    h = h > 0.f ? sum : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 u = *reinterpret_cast<const float4*>(As + (tp + 4 * i) * lda + c0);
    const float4 t = *reinterpret_cast<const float4*>(As + (tp + 4 * i) * lda + c1);
    gh[i][0] = u.x; gh[i][1] = u.y; gh[i][2] = u.z; gh[i][3] = u.w;
    gh[i][4] = t.x; gh[i][5] = t.y; gh[i][6] = t.z; gh[i][7] = t.w;
  }

  // the products in dg_product's order, each with what comes before and after it
  float* pool = a.pool + (size_t)blockIdx.x * 64 * nc + tid;  // NS > 1: the pooled cotangent
  const float inv_ns = 1.f / (float)ns;
  for (int prod = 0; prod < products; ++prod) {
    const DgProduct q = dg_product(a, prod);
    if (q.kind == DG_W1 && q.k >= nlz) {  // a pooled block: its cot1 is gh
      dg_entry(As, lda, tp, c0, c1, gh, cot, stash_slot(q.k, 1, 0, ns, nlz), r0, N, dh);
    } else if (q.kind == DG_W1 && q.k == nlz - 1) {  // a view's first block
      if (ns > 1) {  // this thread's 64 values, coalesced over the threads
        if (q.v == 0) {
#pragma unroll
          for (int e = 0; e < 64; ++e) pool[(size_t)e * nc] = gh[e >> 3][e & 7];
        }
#pragma unroll
        for (int e = 0; e < 64; ++e) gh[e >> 3][e & 7] = pool[(size_t)e * nc] * inv_ns;
      }
      dg_entry(As, lda, tp, c0, c1, gh, cot, stash_slot(q.k, 1, q.v, ns, nlz), r0, N, dh);
    } else if (q.kind == DG_WZ && q.cb == 0) {
      // injection k: its output cotangent G_k is gh (block k - 1's cot1, or
      // lin_in's output cotangent), the A operand of its latent product and
      // of block k - 1's (or lin_in's)
      dg_entry(As, lda, tp, c0, c1, gh, cot,
               q.k > 0 ? stash_slot(q.k - 1, 1, q.v, ns, nlz) : cot_in_slot(q.v, ns, nb, nlz),
               r0, N, dh);
    }
    if (q.kind <= DG_W0) {
      dg_consume<8>(a, p, As, lda, dh, acc);
      const bool w1 = q.kind == DG_W1;
      float m[8][8];
      dg_mask(static_cast<const float*>(a.stash) +
                  stash_slot(q.k, w1 ? 1 : 0, q.v, ns, nlz) * slot,
              tp, c0, c1, r0, N, dh, m);
      if (w1) {  // c0 = mask(relu(fc_0)) * (gh @ W1)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (!(m[i][j] > 0.f)) acc[i][j] = 0.f;
        dg_entry(As, lda, tp, c0, c1, acc, cot, stash_slot(q.k, 0, q.v, ns, nlz), r0, N, dh);
      } else {  // gh += mask(relu(h)) * (c0 @ W0)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (m[i][j] > 0.f) gh[i][j] += acc[i][j];
      }
    } else {
      switch (dg_mode(q.cw, dh)) {
        case 8: dg_narrow<8>(a, p, As, lda, Es, q, acc); break;
        case 4: dg_narrow<4>(a, p, As, lda, Es, q, acc); break;
        case 2: dg_narrow<2>(a, p, As, lda, Es, q, acc); break;
        default: dg_narrow<1>(a, p, As, lda, Es, q, acc); break;
      }
    }
  }
}

// float32 only: the bf16 dgrad is csrc/resnetfc_hopper.cu's
// (avr_resnetfc_dgrad_bf16).  wi, wz, w0, w1 as nn.Linear keeps them.
extern "C" int avr_resnetfc_dgrad(const void* x, const void* g, const void* stash,
                                  const void* wi, const void* wz, const void* w0, const void* w1,
                                  const void* wo, const void* bo, const void* tables,
                                  const void* fph, void* dx, void* dz, void* cot, void* gout,
                                  void* enc, void* pool, int N, int ns, int d_in, int k_in,
                                  int d_latent, int d_hidden, int d_out, int n_blocks,
                                  int n_lin_z, int activate, int dtype, void* stream) {
  const uintptr_t aligned = (uintptr_t)stash | (uintptr_t)wi | (uintptr_t)wz | (uintptr_t)w0 |
                            (uintptr_t)w1 | (uintptr_t)dz | (uintptr_t)cot;
  if (dtype != 0 || N < 1 || ns < 1 || d_hidden % 64 || d_hidden < 64 || d_hidden > 512 ||
      d_latent % 64 || d_latent < 64 || k_in % F32_IN_W || k_in < F32_IN_W || d_out > GOUT_W ||
      n_lin_z < 1 || n_lin_z > n_blocks || (ns > 1 && !pool) || (aligned & 15))
    return (int)cudaErrorInvalidValue;
  FcBwdArgs a;
  a.x = (const float*)x; a.g = (const float*)g; a.stash = stash; a.wi = wi; a.wz = wz;
  a.w0 = w0; a.w1 = w1; a.wo = wo; a.bo = (const float*)bo; a.tables = (const int*)tables;
  a.fph = (const float*)fph; a.dx = (float*)dx; a.dz = dz; a.cot = cot; a.gout = gout;
  a.enc = enc; a.pool = (float*)pool; a.N = N; a.ns = ns; a.d_in = d_in; a.k_in = k_in;
  a.d_latent = d_latent; a.d_hidden = d_hidden; a.d_out = d_out; a.n_blocks = n_blocks;
  a.n_lin_z = n_lin_z; a.activate = activate;
  const size_t smem = dg_smem_bytes(d_hidden);
  cudaError_t e = cudaFuncSetAttribute(resnetfc_dgrad_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((N + F32_TM - 1) / F32_TM);
  resnetfc_dgrad_f32_kernel<<<blocks, d_hidden / 2, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
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
