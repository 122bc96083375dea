// K2's bf16 kernels on Hopper: the forward, the dgrad walk and its tail,
// and the wgrad, on wgmma with TMA-fed tiles.
//
// Replaces avr_tpu/ops/pallas/resnetfc.py's forward fused_resnetfc (:896,
// kernel call :726, stash outputs :637-653), its stash backward
// _bwd_stash_impl (:400-575, call :823) and, run per chunk as the stash
// forward into the chunk's workspace, the dgrad and the wgrad, the
// recompute backward _bwd_impl (:248-390, call :853).  The float32
// instantiations, and bf16 forwards outside this forward's envelope
// (ops/kernels/resnetfc.py forward_route), keep csrc/resnetfc.cu's kernels.
//
// Forward (resnetfc_fwd_wgmma_kernel).  Bound on H100: operations (13
// products of up to 512 x 512 a point, 6.86 MFLOP; 0.57 ms at 81,920 points
// at the bf16 peak) and, with the stash, its bytes (11 rows of 512 bf16 a
// point: 3.7 GB, 1.1 ms at 327,680).  It is the walk's machinery run
// forward: a 64-point tile per CTA, two consumer warpgroups each owning
// d_hidden / 2 trunk columns (the float32 trunk h in registers, one m64n128
// accumulator), a producer thread streaming every product's weight k-slabs
// (nn.Linear (out, in) rows: K-major B operands as they lie) through the
// 3-stage ring ahead of use across product boundaries, so the weights cross
// L2 once per 64 points instead of once per 32 (csrc/resnetfc.cu's
// mma.sync design read them from L2 with synchronous loads).  Each product's
// rounded activation is written once into the A tile, and the ones the
// stash keeps are stored from there by TMA (rows past N clipped by the
// tensor map).  An encoded input or latent wider than the A tile's 512
// lanes (the global encoder's 640, a 5-stage encoder's 1,024) runs in
// pieces of up to 768 lanes through the A tile and the park tiles beside
// it.  Details at the kernel.
//
// Dgrad walk (resnetfc_dgrad_walk_kernel).  Bound on H100: operations and
// the stash/cotangent bytes (2 x 512 x 512 products a block a point; 11
// stash rows read and 11 cotangent rows written, bf16).  Per CTA a tile of
// DG_M = 64 points walks the chain in reverse with exactly the rounding and
// mask order of chip_smoke.py decoder_bwd_matched's block (and of the
// float32 dgrad's, csrc/resnetfc.cu resnetfc_dgrad_f32_kernel): the rounded trunk
// cotangent round(gh) is the A operand of the fc_1 product; its output,
// masked by relu(fc_0) > 0 and rounded, is the A operand of the fc_0
// product; that output, masked by relu(h) > 0, adds into gh.  Budget (227
// KB of shared memory, 65,536 registers):
//   registers: two consumer warpgroups own d_hidden / 2 columns each; the
//     float32 trunk cotangent gh (64 x 256 per warpgroup: 128 registers a
//     thread) and one m64n128 accumulator (64) live in registers
//     (setmaxnreg: 232 for the consumers, 40 for the producer warpgroup);
//   shared: the A tile (64 x d_hidden bf16, 64 KB, single buffer, in the
//     swizzled K-major layout wgmma reads; it is also the tile the TMA
//     stores to the product's cotangent slot), a ring of DG_WSTAGES = 3
//     weight stages (each a 64 (k) x 128 (n) slab per warpgroup, 32 KB),
//     and four 16 KB mask tiles (the stash rows of the next product's ReLU
//     mask, per warpgroup and half, loaded by TMA while the current product
//     runs; the fc_1 product's first half also parks its masked output
//     there until the A tile is free).
// A producer thread streams each product's transposed weight (k-slabs of
// w1T / w0T, K-major B operands) through the ring and each product's mask
// tiles, ahead of use; the weights are read from L2 once per 64 points
// (twice as many points per byte as the 32-point design).  Each product's
// rounded output tile is written once into the A tile and stored from
// there to its cotangent slot by TMA (the wgrad's operand).  Before the
// first product, lin_out's backward reads its input tile (brought into A
// by TMA) and Wo's rows from shared memory, and forms the initial trunk
// cotangent by a compact loop into the (still empty) weight ring, from
// where each thread takes its accumulator positions: the code runs once a
// tile, and straight-line code a value long is fetched cold each time (a
// clock64 timeline of one CTA on the card put it at half a tile's cycles).
//
// Dgrad tail (resnetfc_dgrad_tail_kernel).  Per 128-point tile and view: dz
// = the three injections' rounded cotangents (the rows the walk stored:
// cot_in and fc_1's output slots of blocks 0 .. n_lin_z - 2) @ [Wz_0; Wz_1;
// ...] as one K = n_lin_z x d_hidden product, rounded once; d encoding =
// cot_in @ Wi (float32 in shared memory); then dx through the encoding's
// cos lanes and the encoded input, as csrc/resnetfc.cu computes them.  A
// and B tiles both come by TMA through one ring; bound by the operand bytes
// it reads (the weights once per 128 points, the cotangent rows once per
// 256 output columns).
//
// Wgrad (resnetfc_wgrad_wgmma_kernel + resnetfc_wgrad_reduce_kernel).
// dW (Mg x Ka) += G^T A and db (Mg) += column sums of G over the rows of
// each job.  Bound on H100: bytes at the K2 band call (7.7 GB of operands,
// 2.3 ms) and nearly operations (2.2 TFLOP).  128 x 128 dW tiles, two
// consumer warpgroups of m64n128k16 (one wgmma group in flight) and one
// producer thread; both operands stored points-major, so G enters as an
// MN-major A operand and A as an MN-major B operand, 64 rows a stage through
// a 6-stage (192 KB) TMA ring.  (A 128 x 256 tile, reading a quarter fewer
// operand bytes per product, measured slower on the card.)  Rows
// split by the host plan (ops/kernels/resnetfc.py wgrad_plan) into enough
// CTAs to fill the card; a job's CTAs for one row range are adjacent in the
// grid, so they run together and share G and A through L2.  Each CTA
// writes its float32 partial tile (and its share of the bias sums of the
// same rounded G: the row range's column tiles take turns by stage) to a
// partials buffer; a second kernel
// adds the splits in order into dW and db: deterministic, and each dW
// element is read and written once per launch instead of taking one atomic
// per row chunk.

#include "hopper.cuh"
#include "resnetfc.cuh"

// Every kernel here takes its tiles from dynamic shared memory; one
// file-scope name lets the walk's helpers address their tiles by constant
// offsets instead of holding pointers in registers.
extern __shared__ __align__(1024) unsigned char g_smem[];

// ---------------------------------------------------------------------------
// dgrad walk
// ---------------------------------------------------------------------------

constexpr int DG_M = 64;                      // points per CTA
constexpr int DG_THREADS = 384;               // two consumer warpgroups, one producer
constexpr uint32_t DG_BOX = 64 * 128;         // a {64 columns, 64 rows} bf16 box
constexpr uint32_t DG_SLAB = 128 * 128;       // a {64 k, 128 n} bf16 weight box
constexpr int DG_WSTAGES = 3;
constexpr uint32_t DG_A = 0;                                   // A tile: <= 8 boxes
constexpr uint32_t DG_W = DG_A + 8 * DG_BOX;                   // weight ring
constexpr uint32_t DG_MASK = DG_W + DG_WSTAGES * 2 * DG_SLAB;  // 2 x 2 mask tiles
constexpr uint32_t DG_BAR = DG_MASK + 4 * 2 * DG_BOX;
constexpr uint32_t DG_SMEM = DG_BAR + 16 * 8;
// Before the first product the mask tiles hold lin_out's weight rows (at
// most GOUT_W x 512 bf16, rows padded by 8 so a column read of the rows
// meets distinct banks) and the tile's rounded output cotangent; the weight
// ring stages each warpgroup's initial trunk cotangent, 128 columns at a
// time (rows padded by 4 floats).
constexpr int DG_WO_LD = 512 + 8;
constexpr uint32_t DG_WO = DG_MASK;
constexpr uint32_t DG_GS = DG_WO + GOUT_W * DG_WO_LD * 2;  // 64 x GOUT_W floats
constexpr int DG_GH_LD = 128 + 4;
constexpr uint32_t DG_GH = DG_W;  // two (64 x DG_GH_LD) float tiles, one per warpgroup

struct __align__(64) DgradMaps {
  CUtensorMap w1T, w0T;  // (n_blocks, dh n, dh k), boxes {64 k, 128 n, 1}
  CUtensorMap stash;     // (stash_slots, N, dh), boxes {64, 64, 1}
  CUtensorMap cot;       // (cot_slots, N, dh), boxes {64, 64, 1}
  CUtensorMap wzT;       // (n_lin_z, dl n, dh k), boxes {64 k, 128 n, 1}
  CUtensorMap wiT;       // (k_in n, dh k), boxes {64 k, 128 n}
};

// Product p of a tile's walk: the post-pool blocks from the last down,
// then per view the pre-pool blocks; each block's fc_1 product (w1 = 1),
// then its fc_0 product.
struct Product {
  int w1, blk, v;
};
__device__ __forceinline__ Product product_of(int p, int nb, int nlz) {
  const int post = 2 * (nb - nlz);
  Product q;
  q.w1 = (p & 1) == 0;
  if (p < post) {
    q.blk = nb - 1 - p / 2;
    q.v = 0;
  } else {
    const int r = p - post;
    q.v = r / (2 * nlz);
    q.blk = nlz - 1 - (r % (2 * nlz)) / 2;
  }
  return q;
}

__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf_at(const unsigned char* base, uint32_t off) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(base + off));
}

// The consumer warpgroups' state in the walk: the tiles, the barriers,
// this thread's place, the weight ring's position (ws) and the product
// count (p: one use of each mask tile per product).
struct WalkCtx {
  const CUtensorMap* cot;
  int tid, t, wg, HW, halves, kch, r0, ws, p;
};
__device__ __forceinline__ unsigned char* walk_A() { return g_smem + DG_A; }
__device__ __forceinline__ unsigned char* walk_W() { return g_smem + DG_W; }
__device__ __forceinline__ uint64_t* walk_bar(int i) {
  return reinterpret_cast<uint64_t*>(g_smem + DG_BAR) + i;
}
// the barriers: wfull[DG_WSTAGES], wempty[DG_WSTAGES], mfull[4], mempty[4]
// (indexed wg * 2 + half), afull, idone
__device__ __forceinline__ uint64_t* walk_mfull(int m) { return walk_bar(2 * DG_WSTAGES + m); }
__device__ __forceinline__ uint64_t* walk_mempty(int m) { return walk_bar(2 * DG_WSTAGES + 4 + m); }
__device__ __forceinline__ unsigned char* walk_mask(const WalkCtx& c, int h) {
  return g_smem + DG_MASK + (uint32_t)(c.wg * 2 + h) * 2 * DG_BOX;
}

// Before A is rewritten: the last TMA store has read it and every product
// reading it has finished.
__device__ __forceinline__ void walk_begin_write(const WalkCtx& c) {
  if (c.tid == 0) tma_store_wait_read();
  named_sync(1, 256);
}
// A is complete: store it to its cotangent slot.
__device__ __forceinline__ void walk_end_write_store(const WalkCtx& c, int slot) {
  fence_async_shared();
  named_sync(1, 256);
  if (c.tid == 0) {
    for (int b = 0; b < c.kch; ++b) tma_store_3d(c.cot, walk_A() + b * DG_BOX, b * 64, c.r0, slot);
    tma_store_commit();
  }
}
// The epilogues move 8 x 8 bf16 matrices between shared memory and the
// accumulator fragment with ldmatrix / stmatrix: matrix (j, hr) of a
// warpgroup's 64 x 128 half is rows 16 warp + 8 hr .. + 7, columns 8 j .. +
// 7; thread (g = lane / 4, t = lane % 4) holds its row g, columns 2 t, 2 t +
// 1: accumulator registers 4 j + 2 hr and 4 j + 2 hr + 1.  An x4 operation
// q covers blocks 2 q and 2 q + 1 (registers 8 q .. 8 q + 7); lane L gives
// the address of row L % 8 of matrix L / 8 = (block 2 q + L / 16, hr (L / 8)
// % 2).  Returns the byte offset of lane L's row in a tile of 64-row boxes,
// at column col0 + 16 q.
__device__ __forceinline__ uint32_t frag_row_off(const WalkCtx& c, int col0, int q) {
  const int lane = c.t & 31, m = lane >> 3;
  return swz_off(16 * (c.t >> 5) + 8 * (m & 1) + (lane & 7), col0 + 16 * q + 8 * (m >> 1), DG_BOX);
}
__device__ __forceinline__ void ldsm_x4(const unsigned char* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void stsm_x4(unsigned char* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(smem_u32(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}
// The two bf16 of a register, as floats: the mask test relu(x) > 0.
__device__ __forceinline__ bool pos_lo(uint32_t v) { return __uint_as_float(v << 16) > 0.f; }
__device__ __forceinline__ bool pos_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u) > 0.f; }
// Columns 16 q .. 16 q + 15 of half h lie in this warpgroup's range (HW is
// a multiple of 32: whole 16-column groups are in or out).
__device__ __forceinline__ bool walk_cols_live(const WalkCtx& c, int h, int q) {
  return h < c.halves && h * 128 + 16 * q < c.HW;
}

// A := round(gh) at this thread's positions.
__device__ __forceinline__ void walk_write_gh(const WalkCtx& c, const float (&gh)[2][64]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (walk_cols_live(c, h, q)) {
        uint32_t r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) r[k] = bf2(gh[h][8 * q + 2 * k], gh[h][8 * q + 2 * k + 1]);
        stsm_x4(walk_A() + frag_row_off(c, c.wg * c.HW + h * 128, q), r);
      }
}
// acc = A @ W for the next half of this warpgroup's columns: the next kch
// stages of an S-stage ring (A's first kch boxes; with JUMP, boxes from the
// ninth on lie JUMP bytes further), one wgmma group in flight.  The ring's
// barriers: full[S] then empty[S].
template <int S = DG_WSTAGES, uint32_t JUMP = 0>
__device__ __forceinline__ void walk_kloop(WalkCtx& c, float (&acc)[64], int kch) {
  for (int kc = 0; kc < kch; ++kc) {
    const int st = c.ws % S;
    mbar_wait(walk_bar(st), (c.ws / S) & 1);
    const unsigned char* wb = walk_W() + st * 2 * DG_SLAB + c.wg * DG_SLAB;
    const unsigned char* ab = walk_A() + kc * DG_BOX + (JUMP && kc >= 8 ? JUMP : 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16<0, 0>(acc, gmma_desc(ab + kk * 32, 16, 1024),
                             gmma_desc(wb + kk * 32, 16, 1024), kc > 0 || kk > 0);
    wgmma_commit();
    if (kc > 0) {
      wgmma_wait<1>();
      mbar_arrive(walk_bar(S + (c.ws - 1) % S));
    }
    ++c.ws;
  }
  wgmma_wait<0>();
  mbar_arrive(walk_bar(S + (c.ws - 1) % S));
}
// fc_1's backward: gnet = mask(relu(fc_0) > 0) * (round(gh) @ W1), rounded,
// into A and stored to slot.  The first half's output waits in its mask
// tile until every product reading A has finished.
__device__ __forceinline__ void walk_fc1(WalkCtx& c, float (&acc)[64], int slot) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h >= c.halves) break;
    walk_kloop(c, acc, c.kch);
    unsigned char* mb = walk_mask(c, h);
    mbar_wait(walk_mfull(c.wg * 2 + h), c.p & 1);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t m[4];
      ldsm_x4(mb + frag_row_off(c, 0, q), m);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float& lo = acc[8 * q + 2 * k];
        float& hi = acc[8 * q + 2 * k + 1];
        lo = pos_lo(m[k]) ? lo : 0.f;
        hi = pos_hi(m[k]) ? hi : 0.f;
        m[k] = bf2(lo, hi);
      }
      if (h < c.halves - 1) stsm_x4(mb + frag_row_off(c, 0, q), m);  // parked
    }
    if (h == c.halves - 1) mbar_arrive(walk_mempty(c.wg * 2 + h));
  }
  walk_begin_write(c);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h >= c.halves) break;
    const unsigned char* mb = walk_mask(c, h);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (walk_cols_live(c, h, q)) {
        uint32_t r[4];
        if (h == c.halves - 1) {
#pragma unroll
          for (int k = 0; k < 4; ++k) r[k] = bf2(acc[8 * q + 2 * k], acc[8 * q + 2 * k + 1]);
        } else {
          ldsm_x4(mb + frag_row_off(c, 0, q), r);
        }
        stsm_x4(walk_A() + frag_row_off(c, c.wg * c.HW + h * 128, q), r);
      }
    if (h < c.halves - 1) mbar_arrive(walk_mempty(c.wg * 2 + h));
  }
  walk_end_write_store(c, slot);
  ++c.p;
}
// fc_0's backward: gh += mask(relu(h) > 0) * (gnet @ W0).
__device__ __forceinline__ void walk_fc0(WalkCtx& c, float (&acc)[64], float (&gh)[2][64]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h >= c.halves) break;
    walk_kloop(c, acc, c.kch);
    const unsigned char* mb = walk_mask(c, h);
    mbar_wait(walk_mfull(c.wg * 2 + h), c.p & 1);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t m[4];
      ldsm_x4(mb + frag_row_off(c, 0, q), m);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (pos_lo(m[k])) gh[h][8 * q + 2 * k] += acc[8 * q + 2 * k];
        if (pos_hi(m[k])) gh[h][8 * q + 2 * k + 1] += acc[8 * q + 2 * k + 1];
      }
    }
    mbar_arrive(walk_mempty(c.wg * 2 + h));
  }
  ++c.p;
}

__global__ void __launch_bounds__(DG_THREADS, 1)
resnetfc_dgrad_walk_kernel(const __grid_constant__ DgradMaps maps, const FcBwdArgs a) {
  unsigned char* smem = g_smem;
  unsigned char* A = smem + DG_A;
  unsigned char* W = smem + DG_W;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + DG_BAR);
  uint64_t* wfull = bars;                    // [DG_WSTAGES]
  uint64_t* wempty = bars + DG_WSTAGES;      // [DG_WSTAGES]
  uint64_t* mfull = bars + 2 * DG_WSTAGES;   // [wg * 2 + half]
  uint64_t* mempty = mfull + 4;              // [wg * 2 + half]
  uint64_t* afull = mempty + 4;              // lin_out's input tile has landed in A
  uint64_t* idone = afull + 1;               // the epilogue is done with the mask tiles

  const int dh = a.d_hidden, nb = a.n_blocks, nlz = a.n_lin_z, ns = a.ns, N = a.N;
  const int HW = dh / 2, halves = (HW + 127) / 128, kch = dh / 64;
  const int n_prod = 2 * (nb - nlz) + ns * 2 * nlz;
  const int tid = threadIdx.x, wg = tid >> 7, r0 = blockIdx.x * DG_M;
  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
    for (int s = 0; s < DG_WSTAGES; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], 256);
    }
    for (int m = 0; m < 4; ++m) {
      mbar_init(&mfull[m], 1);
      mbar_init(&mempty[m], 128);
    }
    mbar_init(afull, 1);
    mbar_init(idone, 256);
    mbar_fence_init();
    // lin_out's input (the stash's last slot) into A, where the epilogue reads it
    mbar_expect_tx(afull, kch * DG_BOX);
    for (int b = 0; b < kch; ++b)
      tma_load_3d(A + b * DG_BOX, &maps.stash, afull, b * 64, r0, stash_slots(ns, nb, nlz) - 1);
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the weight ring and the mask tiles ahead
    setmaxnreg_dec<40>();
    if (tid != 256) return;
    int ws = 0;
    mbar_wait(idone, 0);  // the epilogue is done with the ring and the mask tiles
    for (int p = 0; p < n_prod; ++p) {
      const Product q = product_of(p, nb, nlz);
      const CUtensorMap* wm = q.w1 ? &maps.w1T : &maps.w0T;
      const int mslot = stash_slot(q.blk, q.w1 ? 1 : 0, q.v, ns, nlz);
      for (int h = 0; h < halves; ++h)
        for (int kc = 0; kc < kch; ++kc) {
          const int st = ws % DG_WSTAGES;
          if (ws >= DG_WSTAGES) mbar_wait(&wempty[st], (ws / DG_WSTAGES - 1) & 1);
          unsigned char* dst = W + st * 2 * DG_SLAB;
          mbar_expect_tx(&wfull[st], 2 * DG_SLAB);
          tma_load_3d(dst, wm, &wfull[st], kc * 64, h * 128, q.blk);
          tma_load_3d(dst + DG_SLAB, wm, &wfull[st], kc * 64, HW + h * 128, q.blk);
          ++ws;
          if (h == 0 && kc == min(1, kch - 1)) {  // the product's mask tiles
            for (int m = 0; m < 2 * halves; ++m) {
              const int mw = m / halves, mh = m % halves, slot = m / halves * 2 + mh;
              if (p > 0) mbar_wait(&mempty[slot], (p - 1) & 1);
              unsigned char* md = smem + DG_MASK + (uint32_t)slot * 2 * DG_BOX;
              const int c0 = mw * HW + mh * 128;
              mbar_expect_tx(&mfull[slot], 2 * DG_BOX);
              tma_load_3d(md, &maps.stash, &mfull[slot], c0, r0, mslot);
              tma_load_3d(md + DG_BOX, &maps.stash, &mfull[slot], c0 + 64, r0, mslot);
            }
          }
        }
    }
    return;
  }

  // consumers: warpgroup wg owns columns [wg HW, (wg + 1) HW)
  setmaxnreg_inc<232>();
  const int t = tid & 127;
  bf16* wo_s = reinterpret_cast<bf16*>(smem + DG_WO);
  float* gs = reinterpret_cast<float*>(smem + DG_GS);
  float gh[2][64];
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // lin_out and the epilogue: g_epi = g * act'(out_pre), rounded;
  // gh = mask(aout) * (g_epi @ Wo).  Wo's rows into shared memory, aout
  // (lin_out's input) from the tile the TMA brought into A.
  {
    const uint4* wo = static_cast<const uint4*>(a.wo);
    const int rv = dh / 8;  // 16-byte vectors a row
    for (int i = tid; i < a.d_out * rv; i += 256)
      *reinterpret_cast<uint4*>(wo_s + (i / rv) * DG_WO_LD + (i % rv) * 8) = wo[i];
  }
  named_sync(1, 256);
  mbar_wait(afull, 0);
  // one thread a (point, output) pair; the rounded cotangent's lanes past
  // d_out are zero
  for (int idx = tid; idx < DG_M * (GOUT_W - a.d_out); idx += 256) {
    const int r = idx / (GOUT_W - a.d_out), o = a.d_out + idx % (GOUT_W - a.d_out);
    gs[r * GOUT_W + o] = 0.f;
    if (r0 + r < N) static_cast<bf16*>(a.gout)[(size_t)(r0 + r) * GOUT_W + o] = from_f<bf16>(0.f);
  }
  for (int idx = tid; idx < DG_M * a.d_out; idx += 256) {
    const int r = idx / a.d_out, o = idx - r * a.d_out, row = r0 + r;
    float gv = 0.f;
    if (row < N) {
      gv = a.g[(size_t)row * a.d_out + o];
      if (a.activate) {
        const bf16* wrow = wo_s + o * DG_WO_LD;
        float sum = 0.f;
#pragma unroll 4
        for (int k = 0; k < dh; k += 8) {
          float av[8], wv[8];
          load16_shared(reinterpret_cast<const bf16*>(A + swz_off(r, k, DG_BOX)), av);
          load16_shared(wrow + k, wv);
#pragma unroll
          for (int j = 0; j < 8; ++j) sum = fmaf(av[j], wv[j], sum);
        }
        const float pre = sum + a.bo[o];
        if (o < 3) {
          const float sg = sigmoidf_(pre);
          gv = gv * sg * (1.f - sg);
        } else if (!(pre > 0.f)) {
          gv = 0.f;
        }
      }
      gv = round_to<bf16>(gv);
    }
    gs[r * GOUT_W + o] = gv;
    if (row < N) static_cast<bf16*>(a.gout)[(size_t)row * GOUT_W + o] = from_f<bf16>(gv);
  }
  named_sync(1, 256);
  // per half: the values by a compact loop into this warpgroup's staging
  // tile, then into the accumulator layout (straight-line code per value
  // would be fetched cold for every tile)
  float* stage = reinterpret_cast<float*>(smem + DG_GH) + wg * DG_M * DG_GH_LD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h < halves) {
      // this thread's column: Wo's entries once, then one row a step
      const int cl = h * 128 + t, col = wg * HW + cl;
      float w[GOUT_W];
#pragma unroll
      for (int o = 0; o < GOUT_W; ++o) w[o] = o < a.d_out && cl < HW ? to_f(wo_s[o * DG_WO_LD + col]) : 0.f;
      for (int r = 0; r < DG_M; ++r) {
        float v = 0.f;
        if (cl < HW && r0 + r < N) {
          const float4 g0 = *reinterpret_cast<const float4*>(gs + r * GOUT_W);
          const float4 g1 = *reinterpret_cast<const float4*>(gs + r * GOUT_W + 4);
          const float gr[GOUT_W] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
          float sum = 0.f;
#pragma unroll
          for (int o = 0; o < GOUT_W; ++o)
            if (o < a.d_out) sum = fmaf(gr[o], w[o], sum);
          v = bf_at(A, swz_off(r, col, DG_BOX)) > 0.f ? sum : 0.f;
        }
        stage[r * DG_GH_LD + t] = v;
      }
      named_sync(2 + wg, 128);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i)
      gh[h][i] = h < halves ? stage[acc_row(t, i) * DG_GH_LD + acc_col(t, i)] : 0.f;
    named_sync(2 + wg, 128);  // the staging tile is rewritten by the next half
  }
  mbar_arrive(idone);  // the producer may fill the ring and the mask tiles

  WalkCtx c{&maps.cot, tid, t, wg, HW, halves, kch, r0, 0, 0};
  // the chain: ns = 1 walks blocks nb - 1 .. 0 in one segment; ns > 1 the
  // post-pool blocks (segment 0), then per view the pre-pool blocks
  const int segs = ns == 1 ? 1 : 1 + ns;
  const float inv_ns = 1.f / (float)ns;
  float* pool = ns > 1 ? a.pool + (size_t)r0 * dh : nullptr;
  for (int seg = 0; seg < segs; ++seg) {
    const int v = seg == 0 ? 0 : seg - 1;
    const int k_hi = seg == 0 ? nb - 1 : nlz - 1, k_lo = seg == 0 && ns > 1 ? nlz : 0;
    if (seg > 0) {  // gh = pooled cotangent / ns, from this thread's own positions
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int cl = h * 128 + acc_col(t, i);
          if (h < halves && cl < HW) gh[h][i] = pool[acc_row(t, i) * dh + wg * HW + cl] * inv_ns;
        }
    }
    // step k_hi + 1 enters the segment (A := round(gh) for block k_hi);
    // step k runs block k, then A := round(gh) for block k - 1 (or, after
    // block 0, lin_in's output)
    for (int k = k_hi + 1; k_hi >= k_lo && k >= k_lo; --k) {
      if (k <= k_hi) {
        walk_fc1(c, acc, stash_slot(k, 0, v, ns, nlz));
        walk_fc0(c, acc, gh);
      }
      const int next = k > k_lo ? stash_slot(k - 1, 1, v, ns, nlz)
                                : (k == 0 ? cot_in_slot(v, ns, nb, nlz) : -1);
      walk_begin_write(c);
      if (next >= 0) {
        walk_write_gh(c, gh);
        walk_end_write_store(c, next);
      }
    }
    if (seg == 0 && ns > 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int cl = h * 128 + acc_col(t, i);
          if (h < halves && cl < HW) pool[acc_row(t, i) * dh + wg * HW + cl] = gh[h][i];
        }
    }
  }
  if (tid == 0) tma_store_wait_read();  // the tile stays until the last store has read it
}

// ---------------------------------------------------------------------------
// forward (bf16): the chain of products the walk runs in reverse, run forward
// ---------------------------------------------------------------------------

struct __align__(64) FwdMaps {
  CUtensorMap wi;      // (dh n, k_in k), boxes {64 k, 128 n}
  CUtensorMap wz;      // (n_lin_z, dh n, dl k), boxes {64 k, 128 n, 1}
  CUtensorMap w0, w1;  // (n_blocks, dh n, dh k), boxes {64 k, 128 n, 1}
  CUtensorMap z;       // (ns, N, dl), boxes {64, 64, 1}
  CUtensorMap stash;   // (stash_slots, N, dh), boxes {64, 64, 1}
};
// The forward's envelope: the A tile holds an operand of at most its 8
// boxes (FWD_K_MAX lanes); d_hidden <= 512 keeps the trunk in the two
// consumer warpgroups' registers, so relu(h) and relu(fc_0) fit it; the
// encoded input and the latent go past it in pieces (FWD_K_EXT, below) up
// to FWD_OPERAND_MAX lanes each (the C entry refuses wider ones).
constexpr int FWD_K_MAX = 8 * 64;
constexpr int FWD_OPERAND_MAX = 18 * 64;
// Its shared memory: the walk's A tile and barrier offsets, a 4-stage
// weight ring from DG_W, then one park tile (64 x 128 bf16) per consumer
// warpgroup.  Barriers: full[4], empty[4], then the latent tile's.
constexpr int FW_STAGES = 4;
constexpr uint32_t FW_PARK = DG_W + FW_STAGES * 2 * DG_SLAB;
static_assert(FW_PARK + 2 * 2 * DG_BOX <= DG_BAR, "the forward's park tiles overlap its barriers");
// Past FWD_K_MAX lanes the two park tiles (4 boxes, free outside fc_0)
// extend the A tile for lin_in's and the injections' operands: a piece of
// up to FWD_K_EXT lanes, box b at fwd_box(b), the ninth box FW_JUMP bytes
// past where A's ninth would be.
constexpr int FWD_K_EXT = FWD_K_MAX + 2 * 2 * 64;
constexpr uint32_t FW_JUMP = FW_PARK - (DG_A + 8 * DG_BOX);
__device__ __forceinline__ uint32_t fwd_box(int b) {
  return DG_A + (uint32_t)b * DG_BOX + (b >= 8 ? FW_JUMP : 0u);
}

// b at the columns of accumulator registers 4 j .. 4 j + 3 of half h (two
// columns, 2 (t % 4) and + 1 past 8 j), zeros past the warpgroup's columns
// (HW is a multiple of 32: both or neither).
__device__ __forceinline__ float2 fwd_bias2(const WalkCtx& c, const float* b, int h, int j) {
  const int cl = h * 128 + 8 * j + 2 * (c.t & 3);
  return cl < c.HW ? *reinterpret_cast<const float2*>(b + c.wg * c.HW + cl)
                   : make_float2(0.f, 0.f);
}
// The epilogues read their biases 16 columns at a time, each group after a
// warp barrier (which orders the warp's memory accesses, so the compiler
// keeps the group's coherent loads below it): the 64 loaded at once, even
// above the wgmma wait, held 32 registers beside the trunk and the
// accumulator, and the trunk spilled to local memory.
__device__ __forceinline__ void fwd_bias_fence() { __syncwarp(); }
__device__ __forceinline__ unsigned char* fwd_park(const WalkCtx& c) {
  return g_smem + FW_PARK + (uint32_t)c.wg * 2 * DG_BOX;
}
// A is complete: make it visible to wgmma (and the TMA) and, for slot >= 0,
// store it to that stash slot.
__device__ __forceinline__ void fwd_end_write(const WalkCtx& c, int slot) {
  if (slot >= 0) {
    walk_end_write_store(c, slot);
  } else {
    fence_async_shared();
    named_sync(1, 256);
  }
}
// A := round(relu(h)) at this thread's positions.
template <int H>
__device__ __forceinline__ void fwd_write_relu(const WalkCtx& c, const float (&h)[H][64]) {
#pragma unroll
  for (int hh = 0; hh < H; ++hh)
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (walk_cols_live(c, hh, q)) {
        uint32_t r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          r[k] = bf2(fmaxf(h[hh][8 * q + 2 * k], 0.f), fmaxf(h[hh][8 * q + 2 * k + 1], 0.f));
        stsm_x4(walk_A() + frag_row_off(c, c.wg * c.HW + hh * 128, q), r);
      }
}
// The trunk's products: h = A @ W^T + b (lin_in, add = false) or h = (h +
// A @ W^T) + b (an injection, fc_1), over kch k-chunks of A.  EXT: A
// extended by the park tiles (fwd_box), b null for a piece of an operand
// before its last (h = A @ W^T or h + A @ W^T alone).
template <int H, bool EXT = false>
__device__ __forceinline__ void fwd_trunk(WalkCtx& c, float (&acc)[64], float (&h)[H][64],
                                          int kch, const float* b, bool add) {
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
    walk_kloop<FW_STAGES, EXT ? FW_JUMP : 0>(c, acc, kch);
    // (h + acc) + b in two passes: the accumulator is free before the
    // biases load
#pragma unroll
    for (int i = 0; i < 64; ++i) h[hh][i] = add ? h[hh][i] + acc[i] : acc[i];
    if (EXT && b == nullptr) continue;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      fwd_bias_fence();
      float2 bb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = fwd_bias2(c, b, hh, 4 * g + j);
#pragma unroll
      for (int i = 16 * g; i < 16 * g + 16; ++i)
        h[hh][i] = h[hh][i] + (i & 1 ? bb[(i >> 2) & 3].y : bb[(i >> 2) & 3].x);
    }
  }
}
// fc_0: A := round(relu(A @ W0^T + b0)), stored to stash slot `slot` (< 0:
// not stored).  The first half's output waits in this warpgroup's park
// tile until every product reading A has finished.
template <int H>
__device__ __forceinline__ void fwd_fc0(WalkCtx& c, float (&acc)[64], const float* b, int slot) {
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
    walk_kloop<FW_STAGES>(c, acc, c.kch);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      fwd_bias_fence();
      float2 bb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = fwd_bias2(c, b, hh, 4 * g + j);
#pragma unroll
      for (int i = 16 * g; i < 16 * g + 16; ++i)
        acc[i] = fmaxf(acc[i] + (i & 1 ? bb[(i >> 2) & 3].y : bb[(i >> 2) & 3].x), 0.f);
    }
    if (hh < H - 1) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) r[k] = bf2(acc[8 * q + 2 * k], acc[8 * q + 2 * k + 1]);
        stsm_x4(fwd_park(c) + frag_row_off(c, 0, q), r);  // parked
      }
    }
  }
  walk_begin_write(c);
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (walk_cols_live(c, hh, q)) {
        uint32_t r[4];
        if (hh == H - 1) {
#pragma unroll
          for (int k = 0; k < 4; ++k) r[k] = bf2(acc[8 * q + 2 * k], acc[8 * q + 2 * k + 1]);
        } else {
          ldsm_x4(fwd_park(c) + frag_row_off(c, 0, q), r);
        }
        stsm_x4(walk_A() + frag_row_off(c, c.wg * c.HW + hh * 128, q), r);
      }
  }
  fwd_end_write(c, slot);
}
// Block k: A := round(relu(h)) (stash slot (k, 0, v)), fc_0 (slot (k, 1,
// v)), h = (h + A @ W1^T) + b1.
template <int H>
__device__ __forceinline__ void fwd_block(WalkCtx& c, float (&acc)[64], float (&h)[H][64],
                                          const FcArgs& a, int k, int v) {
  const bool st = a.stash != nullptr;
  const size_t off = (size_t)k * a.d_hidden;
  walk_begin_write(c);
  fwd_write_relu(c, h);
  fwd_end_write(c, st ? stash_slot(k, 0, v, a.ns, a.n_lin_z) : -1);
  fwd_fc0<H>(c, acc, a.b0 + off, st ? stash_slot(k, 1, v, a.ns, a.n_lin_z) : -1);
  fwd_trunk(c, acc, h, c.kch, a.b1 + off, true);
}

// The forward of one 64-point tile per CTA (bf16 operands, float32 trunk),
// with csrc/resnetfc.cu resnetfc_tile's rounding points and order up to 512
// encoded input and latent lanes: h = acc + bi; per injection h = (h + acc)
// + bz; a block's activations round(relu(h)) and round(relu(acc + b0)),
// then h = (h + acc) + b1; the view sum s = s + h, times 1 / ns; lin_out by
// sequential FMAs.  Each row's arithmetic is independent of its place in
// the tile, so a call over any range of points writes the same bits for
// them (the recompute backward's chunks equal the stash backward's forward).
//
// Wider operands (P, an instantiation of its own; up to FWD_OPERAND_MAX
// lanes) run in pieces of up to FWD_K_EXT = 768 lanes: the A tile's 8 boxes
// and the 4 of the park tiles, which fc_0 alone uses, so an operand of up
// to 768 lanes (the global encoder's 640, 576 encoded lanes) is one product
// over one tile load, as a resident operand would be.  Wider ones (a
// 5-stage encoder's 1,024) take a second piece, brought in when both
// warpgroups have read the first (walk_begin_write): the encoded input
// written by the consumers, the latent loaded by TMA.  The producer streams
// a product's weight k-slabs piece by piece, each half by half.  The trunk
// takes each piece's sum as it comes, h = acc_0 (lin_in) or h + acc_0 (an
// injection), then h = h + acc_p, the bias after the last piece: past 768
// lanes another rounding order than one float32 sum, held to the plain
// version at the bf16 forward's 2^-7 of the largest output (chip_smoke.py
// check_resnetfc_pieces).  Each row's arithmetic stays independent of its
// place in the tile.  At 512 lanes and below the other instantiation runs
// the code without the pieces: their loops, compiled into it, cost the
// 512-lane forward 16% (2.04 against 1.77 ms at the band chunk on an H100,
// the same bits).
//
// Budget: the walk's DG_SMEM (224 KB): the A tile (8 boxes), a 4-stage
// weight ring (128 KB), and a park tile per warpgroup (16 KB each), where
// it keeps its first half of fc_0's output until the other warpgroup has
// finished reading A.  The latent tile is not resident: before each
// injection a consumer thread loads it into A by TMA (A holds one operand
// at a time: the encoding, z, relu(h), relu(fc_0)); the reloads read 64 KB
// a tile per injection from L2.  NS > 1 sums the views in a float32 scratch
// (a.pool: 64 H floats a consumer thread, its own accumulator positions,
// contiguous, so one base address serves them): no atomics, no
// synchronisation.
// H: the halves (128-column slabs) of a warpgroup's d_hidden / 2 columns,
// a compile-time count so that the trunk's registers are all live or absent;
// P: an encoded input or latent past FWD_K_MAX lanes, in pieces.
template <int H, bool P>
__global__ void __launch_bounds__(DG_THREADS, 1)
resnetfc_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps, const FcArgs a) {
  unsigned char* smem = g_smem;
  unsigned char* A = smem + DG_A;
  unsigned char* W = smem + DG_W;
  uint64_t* wfull = walk_bar(0);                // [FW_STAGES]
  uint64_t* wempty = walk_bar(FW_STAGES);       // [FW_STAGES]
  uint64_t* zfull = walk_bar(2 * FW_STAGES);    // the latent tile has landed in A
  const int dh = a.d_hidden, dl = a.d_latent, nb = a.n_blocks, nlz = a.n_lin_z, ns = a.ns;
  const int HW = dh / 2, kdh = dh / 64;
  const int tid = threadIdx.x, wg = tid >> 7, r0 = blockIdx.x * DG_M;
  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], 256);
    }
    mbar_init(zfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread streams every product's weight k-slabs through
    // the ring, ahead of use and across product boundaries
    setmaxnreg_dec<40>();
    if (tid != 256) return;
    int ws = 0;
    // a product over K input lanes: per piece of at most FWD_K_EXT lanes
    // (one piece up to FWD_K_MAX), per half, its k-chunks (the consumers'
    // order)
    auto stream = [&](const CUtensorMap* m, int blk, int K) {  // blk < 0: the 2-d map
      for (int k0 = 0; k0 < K; k0 += FWD_K_EXT)
        for (int h = 0; h < H; ++h)
          for (int kc = k0; kc < min(K, k0 + FWD_K_EXT); kc += 64) {
            const int st = ws % FW_STAGES;
            if (ws >= FW_STAGES) mbar_wait(&wempty[st], (ws / FW_STAGES - 1) & 1);
            unsigned char* dst = W + st * 2 * DG_SLAB;
            mbar_expect_tx(&wfull[st], 2 * DG_SLAB);
            for (int g = 0; g < 2; ++g) {  // each consumer warpgroup's 128 columns
              const int n0 = g * HW + h * 128;
              if (blk < 0)
                tma_load_2d(dst + g * DG_SLAB, m, &wfull[st], kc, n0);
              else
                tma_load_3d(dst + g * DG_SLAB, m, &wfull[st], kc, n0, blk);
            }
            ++ws;
          }
    };
    for (int v = 0; v < ns; ++v) {
      stream(&maps.wi, -1, a.k_in);
      for (int k = 0; k < nlz; ++k) {
        stream(&maps.wz, k, dl);
        stream(&maps.w0, k, dh);
        stream(&maps.w1, k, dh);
      }
    }
    for (int k = nlz; k < nb; ++k) {
      stream(&maps.w0, k, dh);
      stream(&maps.w1, k, dh);
    }
    return;
  }

  // consumers: warpgroup wg owns columns [wg HW, (wg + 1) HW)
  setmaxnreg_inc<232>();
  const int t = tid & 127;
  float h[H][64];
  float acc[64];
  WalkCtx c{&maps.stash, tid, t, wg, HW, H, kdh, r0, 0, 0};
  // this thread's view sums: 64 H floats of its own, contiguous
  float4* pool = ns > 1 ? reinterpret_cast<float4*>(a.pool) +
                               ((size_t)blockIdx.x * 256 + tid) * 16 * H
                         : nullptr;
  const float inv_ns = 1.f / (float)ns;
  int zloads = 0;  // P: the latent pieces loaded so far, zfull's phase
  for (int v = 0; v < ns; ++v) {
    if constexpr (!P) {
      // the encoded input into A: one thread an element, a compact loop
      walk_begin_write(c);
      for (int idx = tid; idx < DG_M * a.k_in; idx += 256) {
        const int r = idx / a.k_in, j = idx - r * a.k_in, row = r0 + r;
        const int mode = a.tables[j];
        float val = 0.f;
        if (row < a.N && mode != 2) {
          const float p = a.x[((size_t)v * a.N + row) * a.d_in + a.tables[a.k_in + j]];
          val = mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[a.k_in + j]));
        }
        *reinterpret_cast<bf16*>(A + swz_off(r, j, DG_BOX)) = from_f<bf16>(val);
      }
      fwd_end_write(c, -1);
      fwd_trunk(c, acc, h, a.k_in / 64, a.bi, false);
    } else {
      // the same in pieces of at most FWD_K_EXT lanes (A and the park
      // tiles): the first h = A @ Wi^T, each later h = h + A @ Wi^T, the
      // bias after the last; the first piece peeled, so that h is dead
      // while it is written
      auto encode = [&](int j0, int kw) {
        walk_begin_write(c);
        for (int idx = tid; idx < DG_M * kw; idx += 256) {
          const int r = idx / kw, jj = idx - r * kw, j = j0 + jj, row = r0 + r;
          const int mode = a.tables[j];
          float val = 0.f;
          if (row < a.N && mode != 2) {
            const float p = a.x[((size_t)v * a.N + row) * a.d_in + a.tables[a.k_in + j]];
            val = mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[a.k_in + j]));
          }
          *reinterpret_cast<bf16*>(g_smem + fwd_box(jj >> 6) + swz_off(r, jj & 63, DG_BOX)) =
              from_f<bf16>(val);
        }
        fwd_end_write(c, -1);
      };
      const int kw0 = min(FWD_K_EXT, a.k_in);
      encode(0, kw0);
      fwd_trunk<H, true>(c, acc, h, kw0 / 64, kw0 == a.k_in ? a.bi : nullptr, false);
      for (int j0 = kw0; j0 < a.k_in; j0 += FWD_K_EXT) {
        const int kw = min(FWD_K_EXT, a.k_in - j0);
        encode(j0, kw);
        fwd_trunk<H, true>(c, acc, h, kw / 64, j0 + kw == a.k_in ? a.bi : nullptr, true);
      }
    }
    for (int k = 0; k < nlz; ++k) {
      if constexpr (!P) {
        // the latent tile into A by TMA (rows past N read as zeros)
        walk_begin_write(c);
        if (tid == 0) {
          mbar_expect_tx(zfull, dl / 64 * DG_BOX);
          for (int b = 0; b < dl / 64; ++b)
            tma_load_3d(A + b * DG_BOX, &maps.z, zfull, b * 64, r0, v);
        }
        mbar_wait(zfull, (v * nlz + k) & 1);
        fwd_trunk(c, acc, h, dl / 64, a.bz + (size_t)k * dh, true);
      } else {
        // in pieces of at most FWD_K_EXT lanes, each load waiting until
        // both warpgroups have read the last; h = h + A @ Wz^T a piece,
        // the bias after the last
        for (int l0 = 0; l0 < dl; l0 += FWD_K_EXT) {
          const int kch = min(FWD_K_EXT, dl - l0) / 64;
          walk_begin_write(c);
          if (tid == 0) {
            mbar_expect_tx(zfull, kch * DG_BOX);
            for (int b = 0; b < kch; ++b)
              tma_load_3d(g_smem + fwd_box(b), &maps.z, zfull, l0 + b * 64, r0, v);
          }
          mbar_wait(zfull, zloads++ & 1);
          fwd_trunk<H, true>(c, acc, h, kch,
                             l0 + kch * 64 == dl ? a.bz + (size_t)k * dh : nullptr, true);
        }
      }
      fwd_block(c, acc, h, a, k, v);
    }
    if (ns > 1) {  // the view sum s = s + h, then s / ns
#pragma unroll
      for (int hh = 0; hh < H; ++hh)
#pragma unroll
        for (int i = 0; i < 64; i += 4) {
          float* hv = &h[hh][i];
          float4 sv = make_float4(hv[0], hv[1], hv[2], hv[3]);
          if (v > 0) {
            const float4 p = pool[hh * 16 + i / 4];
            sv = make_float4(p.x + hv[0], p.y + hv[1], p.z + hv[2], p.w + hv[3]);
          }
          if (v == ns - 1) {
            hv[0] = sv.x * inv_ns;
            hv[1] = sv.y * inv_ns;
            hv[2] = sv.z * inv_ns;
            hv[3] = sv.w * inv_ns;
          } else {
            pool[hh * 16 + i / 4] = sv;
          }
        }
    }
  }
  for (int k = nlz; k < nb; ++k) fwd_block(c, acc, h, a, k, 0);

  // relu(h) (the stash's last slot) -> lin_out: one thread a (point,
  // output) pair, sequential FMAs over A's row and Wo's
  walk_begin_write(c);
  fwd_write_relu(c, h);
  fwd_end_write(c, a.stash ? stash_slots(ns, nb, nlz) - 1 : -1);
  const bf16* wo = static_cast<const bf16*>(a.wo);
  for (int idx = tid; idx < DG_M * a.d_out; idx += 256) {
    const int r = idx / a.d_out, o = idx - r * a.d_out, row = r0 + r;
    if (row >= a.N) continue;
    float s = 0.f;
    for (int k = 0; k < dh; k += 8) {
      float av[8], wv[8];
      load16_shared(reinterpret_cast<const bf16*>(A + swz_off(r, k, DG_BOX)), av);
      load16(wo + (size_t)o * dh + k, wv);
#pragma unroll
      for (int j = 0; j < 8; ++j) s = fmaf(av[j], wv[j], s);
    }
    s = s + a.bo[o];
    if (a.activate) s = o < 3 ? sigmoidf_(s) : fmaxf(s, 0.f);
    a.out[(size_t)row * a.d_out + o] = s;
  }
  if (tid == 0) tma_store_wait_read();  // the tile stays until the last store has read it
}

extern "C" int avr_resnetfc_fwd_bf16(const void* x, const void* z, const void* wi, const void* bi,
                                     const void* wz, const void* bz, const void* w0,
                                     const void* b0, const void* w1, const void* b1,
                                     const void* wo, const void* bo, const void* tables,
                                     const void* fph, void* out, void* stash, void* pool, int N,
                                     int ns, int d_in, int k_in, int d_latent, int d_hidden,
                                     int d_out, int n_blocks, int n_lin_z, int activate,
                                     void* stream) {
  if (N < 1 || ns < 1 || d_hidden % 64 || d_hidden < 64 || d_hidden > 512 || d_latent % 64 ||
      d_latent < 64 || d_latent > FWD_OPERAND_MAX || k_in % 64 || k_in < 64 ||
      k_in > FWD_OPERAND_MAX || d_out > GOUT_W || n_lin_z < 1 || n_lin_z > n_blocks ||
      (ns > 1 && !pool))
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
  const int dh = d_hidden, dl = d_latent;
  FwdMaps m{};  // the stash's map stays zero without a stash
  int e;
  if ((e = map_2d(&m.wi, wi, dh, k_in, k_in, 128)) ||
      (e = map_3d(&m.wz, wz, n_lin_z, dh, dl, 128)) ||
      (e = map_3d(&m.w0, w0, n_blocks, dh, dh, 128)) ||
      (e = map_3d(&m.w1, w1, n_blocks, dh, dh, 128)) ||
      (e = map_3d(&m.z, z, ns, N, dl, 64)) ||
      (stash && (e = map_3d(&m.stash, stash, stash_slots(ns, n_blocks, n_lin_z), N, dh, 64))))
    return e;
  const bool pieces = dl > FWD_K_MAX || k_in > FWD_K_MAX;
  auto kernel = d_hidden > 256 ? (pieces ? resnetfc_fwd_wgmma_kernel<2, true>
                                         : resnetfc_fwd_wgmma_kernel<2, false>)
                               : (pieces ? resnetfc_fwd_wgmma_kernel<1, true>
                                         : resnetfc_fwd_wgmma_kernel<1, false>);
  cudaError_t c = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)DG_SMEM);
  if (c != cudaSuccess) return (int)c;
  kernel<<<(unsigned)((N + DG_M - 1) / DG_M), DG_THREADS, DG_SMEM, (cudaStream_t)stream>>>(m, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dgrad tail: dz and d encoding from the stored cotangents, then dx and enc
// ---------------------------------------------------------------------------

constexpr int TL_M = 128;     // points a CTA: two warpgroups of 64 rows
constexpr int TL_STAGES = 3;
// a stage: A (128 points x 64 k: two boxes) and B (64 k x 256 n: two slabs)
constexpr uint32_t TL_STAGE = 2 * DG_BOX + 2 * DG_SLAB;
constexpr int TL_KIN_MAX = 128;
constexpr uint32_t TL_ES = TL_STAGES * TL_STAGE;  // 128 x k_in floats
constexpr uint32_t TL_BAR = TL_ES + TL_M * TL_KIN_MAX * 4;
constexpr uint32_t TL_SMEM = TL_BAR + 2 * TL_STAGES * 8;

// Per view: ceil(dl / 256) dz passes (K = nlz dh, 256 columns a pass), then
// one d-encoding pass (K = dh, k_in <= 128 columns).  Both warpgroups read
// each stage's B (the weights) for their own 64 points: a 128-point tile
// reads the weights once where two 64-point tiles would read them twice.
__global__ void __launch_bounds__(DG_THREADS, 1)
resnetfc_dgrad_tail_kernel(const __grid_constant__ DgradMaps maps, const FcBwdArgs a) {
  unsigned char* smem = g_smem;
  float* Es = reinterpret_cast<float*>(smem + TL_ES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TL_BAR);
  uint64_t* empty = full + TL_STAGES;
  const int dh = a.d_hidden, dl = a.d_latent, k_in = a.k_in, nb = a.n_blocks, nlz = a.n_lin_z;
  const int ns = a.ns, N = a.N;
  const int kdh = dh / 64, zpasses = (dl + 255) / 256;
  const int tid = threadIdx.x, wg = tid >> 7, r0 = blockIdx.x * TL_M;
  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();
    for (int s = 0; s < TL_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (tid != 256) return;
    int ws = 0;
    for (int v = 0; v < ns; ++v)
      for (int pass = 0; pass <= zpasses; ++pass) {
        const bool z = pass < zpasses;
        const int kch = z ? nlz * kdh : kdh;
        for (int kc = 0; kc < kch; ++kc) {
          const int st = ws % TL_STAGES;
          if (ws >= TL_STAGES) mbar_wait(&empty[st], (ws / TL_STAGES - 1) & 1);
          unsigned char* dst = smem + st * TL_STAGE;
          mbar_expect_tx(&full[st], TL_STAGE);
          const int j = kc / kdh, col = (kc % kdh) * 64;
          const int slot = j == 0 ? cot_in_slot(v, ns, nb, nlz) : stash_slot(j - 1, 1, v, ns, nlz);
          tma_load_3d(dst, &maps.cot, &full[st], col, r0, slot);
          tma_load_3d(dst + DG_BOX, &maps.cot, &full[st], col, r0 + 64, slot);
          for (int n = 0; n < 2; ++n) {
            unsigned char* bd = dst + 2 * DG_BOX + n * DG_SLAB;
            if (z)
              tma_load_3d(bd, &maps.wzT, &full[st], col, pass * 256 + n * 128, j);
            else
              tma_load_2d(bd, &maps.wiT, &full[st], col, n * 128);
          }
          ++ws;
        }
      }
    return;
  }

  setmaxnreg_inc<232>();
  const int t = tid & 127;
  float acc[2][64];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[n][i] = 0.f;
  int ws = 0;
  for (int v = 0; v < ns; ++v) {
    for (int pass = 0; pass <= zpasses; ++pass) {
      const bool z = pass < zpasses;
      const int kch = z ? nlz * kdh : kdh;
      for (int kc = 0; kc < kch; ++kc) {
        const int st = ws % TL_STAGES;
        mbar_wait(&full[st], (ws / TL_STAGES) & 1);
        const unsigned char* sb = smem + st * TL_STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int n = 0; n < 2; ++n)  // (the d-encoding pass's second slab is zeros)
            wgmma_m64n128k16<0, 0>(acc[n], gmma_desc(sb + wg * DG_BOX + kk * 32, 16, 1024),
                                   gmma_desc(sb + 2 * DG_BOX + n * DG_SLAB + kk * 32, 16, 1024),
                                   kc > 0 || kk > 0);
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();
          mbar_arrive(&empty[(ws - 1) % TL_STAGES]);
        }
        ++ws;
      }
      wgmma_wait<0>();
      mbar_arrive(&empty[(ws - 1) % TL_STAGES]);
      if (z) {  // dz, rounded once from the float32 sum
        bf16* dz = static_cast<bf16*>(a.dz) + (size_t)v * N * dl;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 64; i += 2) {
            const int col = pass * 256 + n * 128 + acc_col(t, i);
            const int row = r0 + wg * 64 + acc_row(t, i);
            if (col < dl && row < N)
              *reinterpret_cast<uint32_t*>(dz + (size_t)row * dl + col) =
                  bf2(acc[n][i], acc[n][i + 1]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = acc_col(t, i);
          if (col < k_in) Es[(wg * 64 + acc_row(t, i)) * k_in + col] = acc[0][i];
        }
      }
    }
    named_sync(1, 256);
    // dx through the encoding: sin lanes carry cos(t) * f, raw lanes 1
    for (int idx = tid; idx < TL_M * a.d_in; idx += 256) {
      const int r = idx / a.d_in, lane = idx - r * a.d_in, row = r0 + r;
      if (row >= N) continue;
      const float p = a.x[((size_t)v * N + row) * a.d_in + lane];
      float sum = 0.f;
      for (int j = 0; j < k_in; ++j) {
        const int mode = a.tables[j];
        if (mode == 2 || a.tables[k_in + j] != lane) continue;
        float d = Es[r * k_in + j];
        if (mode == 1) d = d * (cosf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[k_in + j])) * a.fph[j]);
        sum += d;
      }
      a.dx[((size_t)v * N + row) * a.d_in + lane] = sum;
    }
    // the encoded input (lin_in's operand for the wgrad)
    bf16* enc = static_cast<bf16*>(a.enc) + (size_t)v * N * k_in;
    for (int idx = tid; idx < TL_M * k_in; idx += 256) {
      const int r = idx / k_in, j = idx - r * k_in, row = r0 + r;
      if (row >= N) continue;
      const int mode = a.tables[j];
      float val = 0.f;
      if (mode != 2) {
        const float p = a.x[((size_t)v * N + row) * a.d_in + a.tables[k_in + j]];
        val = mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[k_in + j]));
      }
      enc[(size_t)row * k_in + j] = from_f<bf16>(val);
    }
    named_sync(1, 256);  // Es is rewritten by the next view
  }
}

extern "C" int avr_resnetfc_dgrad_bf16(const void* x, const void* g, const void* stash,
                                       const void* wiT, const void* wzT, const void* w0T,
                                       const void* w1T, const void* wo, const void* bo,
                                       const void* tables, const void* fph, void* dx, void* dz,
                                       void* cot, void* gout, void* enc, void* pool, int N, int ns,
                                       int d_in, int k_in, int d_latent, int d_hidden, int d_out,
                                       int n_blocks, int n_lin_z, int activate, void* stream) {
  FcBwdArgs a;
  a.x = (const float*)x; a.g = (const float*)g; a.stash = stash;  // weights: tensor maps
  a.wo = wo; a.bo = (const float*)bo; a.tables = (const int*)tables;
  a.fph = (const float*)fph; a.dx = (float*)dx; a.dz = dz; a.cot = cot; a.gout = gout;
  a.enc = enc; a.pool = (float*)pool; a.N = N; a.ns = ns; a.d_in = d_in; a.k_in = k_in;
  a.d_latent = d_latent; a.d_hidden = d_hidden; a.d_out = d_out; a.n_blocks = n_blocks;
  a.n_lin_z = n_lin_z; a.activate = activate;
  if (N < 1 || d_hidden % 64 || d_hidden > 512 || d_latent % 64 || d_latent > 512 ||
      k_in % 64 || k_in > TL_KIN_MAX || n_lin_z < 1 || n_lin_z > n_blocks)
    return (int)cudaErrorInvalidValue;
  const int dh = d_hidden, dl = d_latent;
  DgradMaps m;
  int e;
  if ((e = map_3d(&m.w1T, w1T, n_blocks, dh, dh, 128)) ||
      (e = map_3d(&m.w0T, w0T, n_blocks, dh, dh, 128)) ||
      (e = map_3d(&m.stash, stash, stash_slots(ns, n_blocks, n_lin_z), N, dh, 64)) ||
      (e = map_3d(&m.cot, cot, cot_slots(ns, n_blocks, n_lin_z), N, dh, 64)) ||
      (e = map_3d(&m.wzT, wzT, n_lin_z, dl, dh, 128)) ||
      (e = map_2d(&m.wiT, wiT, k_in, dh, dh, 128)))
    return e;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((N + DG_M - 1) / DG_M);
  cudaError_t c = cudaFuncSetAttribute(resnetfc_dgrad_walk_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DG_SMEM);
  if (c != cudaSuccess) return (int)c;
  resnetfc_dgrad_walk_kernel<<<blocks, DG_THREADS, DG_SMEM, s>>>(m, a);
  if ((c = cudaGetLastError()) != cudaSuccess) return (int)c;
  c = cudaFuncSetAttribute(resnetfc_dgrad_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)TL_SMEM);
  if (c != cudaSuccess) return (int)c;
  resnetfc_dgrad_tail_kernel<<<(unsigned)((N + TL_M - 1) / TL_M), DG_THREADS, TL_SMEM, s>>>(m, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------

constexpr int WG_TILE = 128;  // dW tile rows (o)
constexpr int WG_ROWS = 64;   // rows (points) a stage
constexpr int WG_GROUP = 8;   // jobs a launch: their tensor maps travel as parameters
constexpr uint32_t WG_BOX = 64 * 128;  // a {64, 64} bf16 box

constexpr int WG_STAGES = 6;
constexpr uint32_t WG_STAGE = 4 * WG_BOX;  // G: 2 boxes (128 o), A: 2 boxes (128 i)
constexpr uint32_t WG_BAR = WG_STAGES * WG_STAGE;
constexpr uint32_t WG_BSUM = WG_BAR + 2 * WG_STAGES * 8;
constexpr uint32_t WG_SMEM = WG_BSUM + 256 * 4;

struct WgmmaJob {
  int rows, Mg, Ka, tiles_i, tiles, chunk, first_block;
  long long part;   // float offset of the job's partial tiles [split][Mg][Ka]
  long long bpart;  // float offset of its bias partials [split][tiles_i][Mg]; -1: no bias
};
struct __align__(64) WgmmaGroup {
  CUtensorMap g[WG_GROUP], a[WG_GROUP];
  WgmmaJob job[WG_GROUP];
  int n_jobs;
};
// The MN-major operands' descriptor fields: 64-wide MN chunks one box apart
// (LBO), 8-row groups of 128-byte rows 1 KB apart (SBO).
constexpr uint32_t WG_LBO = WG_BOX, WG_SBO = 1024;

__global__ void __launch_bounds__(384, 1)
resnetfc_wgrad_wgmma_kernel(const __grid_constant__ WgmmaGroup p, float* __restrict__ part) {
  unsigned char* smem = g_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_BAR);
  uint64_t* empty = full + WG_STAGES;
  float* bsum = reinterpret_cast<float*>(smem + WG_BSUM);
  int j = 0;
  while (j + 1 < p.n_jobs && (int)blockIdx.x >= p.job[j + 1].first_block) ++j;
  const WgmmaJob& job = p.job[j];
  // block -> (split, tile), the tiles of one row range adjacent
  const int local = (int)blockIdx.x - job.first_block;
  const int split = local / job.tiles, tile = local % job.tiles;
  const int ti = tile % job.tiles_i;
  const int o0 = (tile / job.tiles_i) * WG_TILE, i0 = ti * WG_TILE;
  const int rb = split * job.chunk, re = min(job.rows, rb + job.chunk);
  const int steps = (re - rb + WG_ROWS - 1) / WG_ROWS;
  // the bias sums are shared by the row range's column tiles: tile ti sums
  // the stages s with s % tiles_i == ti
  const bool bias = job.bpart >= 0;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (tid != 256) return;
    for (int s = 0; s < steps; ++s) {
      const int st = s % WG_STAGES;
      if (s >= WG_STAGES) mbar_wait(&empty[st], (s / WG_STAGES - 1) & 1);
      unsigned char* buf = smem + st * WG_STAGE;
      const int r = rb + s * WG_ROWS;
      mbar_expect_tx(&full[st], WG_STAGE);
      tma_load_2d(buf, &p.g[j], &full[st], o0, r);
      tma_load_2d(buf + WG_BOX, &p.g[j], &full[st], o0 + 64, r);
      tma_load_2d(buf + 2 * WG_BOX, &p.a[j], &full[st], i0, r);
      tma_load_2d(buf + 3 * WG_BOX, &p.a[j], &full[st], i0 + 64, r);
    }
    return;
  }

  setmaxnreg_inc<232>();  // measured faster than the launch-bound 168
  const int t = tid & 127;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float bs = 0.f;
  const int bcol = tid & 127, brow = (tid >> 7) * 32;  // bias: column, half of the rows
  for (int s = 0; s < steps; ++s) {
    const int st = s % WG_STAGES;
    mbar_wait(&full[st], (s / WG_STAGES) & 1);
    const unsigned char* buf = smem + st * WG_STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16<1, 1>(acc, gmma_desc(buf + wg * WG_BOX + kk * 2048, WG_LBO, WG_SBO),
                             gmma_desc(buf + 2 * WG_BOX + kk * 2048, WG_LBO, WG_SBO), 1);
    wgmma_commit();
    if (bias && s % job.tiles_i == ti)
      for (int k = brow; k < brow + 32; ++k) bs += bf_at(buf, swz_off(k, bcol, WG_BOX));
    if (s > 0) {  // one group in flight: the previous stage is done
      wgmma_wait<1>();
      mbar_arrive(&empty[(s - 1) % WG_STAGES]);
    }
  }
  wgmma_wait<0>();
  if (steps > 0) mbar_arrive(&empty[(steps - 1) % WG_STAGES]);
  // the partial tile (o = o0 + 64 wg + row, i = i0 + col)
  float* dst = part + job.part + (size_t)split * job.Mg * job.Ka;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int o = o0 + wg * 64 + acc_row(t, i), c = i0 + acc_col(t, i);
    if (o < job.Mg && c < job.Ka)
      *reinterpret_cast<float2*>(dst + (size_t)o * job.Ka + c) = make_float2(acc[i], acc[i + 1]);
  }
  if (bias) {
    bsum[tid] = bs;
    named_sync(1, 256);
    if (tid < 128 && o0 + tid < job.Mg)
      part[job.bpart + ((size_t)split * job.tiles_i + ti) * job.Mg + o0 + tid] =
          bsum[tid] + bsum[tid + 128];
  }
}

// dW += the splits' partial tiles in split order (4 floats a thread), and
// db += the bias partials.
__global__ void __launch_bounds__(256) resnetfc_wgrad_reduce_kernel(const __grid_constant__ ReduceArgs r,
                                                                    const float* __restrict__ part) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < r.total;
       e += (long long)gridDim.x * blockDim.x) {
    int j = 0;
    while (j + 1 < r.n_jobs && e >= r.job[j + 1].first) ++j;
    const ReduceJob& q = r.job[j];
    const long long k = e - q.first, n4 = (long long)q.Mg * q.Ka / 4;
    if (k < n4) {
      const float4* src = reinterpret_cast<const float4*>(part + q.part) + k;
      float4 s = src[0];
      for (int sp = 1; sp < q.splits; ++sp) {
        const float4 v = src[sp * n4];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      float4* w = reinterpret_cast<float4*>(q.dW) + k;
      float4 d = *w;
      d.x += s.x; d.y += s.y; d.z += s.z; d.w += s.w;
      *w = d;
    } else {
      const long long o = k - n4;
      float s = 0.f;
      for (int sp = 0; sp < q.bsplits; ++sp) s += part[q.bpart + sp * q.Mg + o];
      q.db[o] += s;
    }
  }
}

int wgrad_reduce(const ReduceArgs& r, const float* part, cudaStream_t s) {
  long long grid = (r.total + 255) / 256;
  if (grid > 132 * 16) grid = 132 * 16;
  resnetfc_wgrad_reduce_kernel<<<(unsigned)grid, 256, 0, s>>>(r, part);
  return (int)cudaGetLastError();
}

// plan: per job (rows, ldg, lda, Mg, Ka, tiles_i, tiles, splits, chunk,
// group, first_block, part, bpart) as ops/kernels/resnetfc.py wgrad_plan
// makes it; groups of at most WG_GROUP jobs, one launch each, then one
// reduction over every job.

extern "C" int avr_resnetfc_wgrad_bf16(const void* const* G, const void* const* A,
                                       void* const* dW, void* const* db, const long long* plan,
                                       int n_jobs, void* part, void* stream) {
  if (n_jobs < 1 || n_jobs > MAX_RJOBS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t c = cudaFuncSetAttribute(resnetfc_wgrad_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WG_SMEM);
  if (c != cudaSuccess) return (int)c;
  ReduceArgs r;
  r.n_jobs = n_jobs;
  long long total = 0;
  for (int j0 = 0; j0 < n_jobs;) {
    WgmmaGroup grp;
    const long long group = plan[j0 * WGRAD_PLAN_W + 9];
    int n = 0, blocks = 0;
    while (j0 + n < n_jobs && plan[(j0 + n) * WGRAD_PLAN_W + 9] == group) {
      const int j = j0 + n;
      const long long* q = plan + j * WGRAD_PLAN_W;
      if (n == WG_GROUP) return (int)cudaErrorInvalidValue;
      WgmmaJob& w = grp.job[n];
      w.rows = (int)q[0]; w.Mg = (int)q[3]; w.Ka = (int)q[4]; w.tiles_i = (int)q[5];
      w.tiles = (int)q[6]; w.chunk = (int)q[8]; w.first_block = (int)q[10];
      w.part = q[11]; w.bpart = db[j] ? q[12] : -1;
      if (w.chunk % WG_ROWS || w.Ka % 4 || q[11] % 4) return (int)cudaErrorInvalidValue;
      int e;
      if ((e = map_2d(&grp.g[n], G[j], w.rows, w.Mg, q[1], 64)) ||
          (e = map_2d(&grp.a[n], A[j], w.rows, w.Ka, q[2], 64)))
        return e;
      blocks = w.first_block + w.tiles * (int)q[7];
      ReduceJob& rj = r.job[j];
      rj.dW = (float*)dW[j]; rj.db = (float*)db[j]; rj.part = q[11]; rj.bpart = w.bpart;
      rj.first = total; rj.Mg = w.Mg; rj.Ka = w.Ka; rj.splits = (int)q[7];
      rj.bsplits = (int)q[7] * w.tiles_i;
      total += (long long)w.Mg * w.Ka / 4 + (db[j] ? w.Mg : 0);
      ++n;
    }
    grp.n_jobs = n;
    resnetfc_wgrad_wgmma_kernel<<<blocks, 384, WG_SMEM, s>>>(grp, (float*)part);
    if ((c = cudaGetLastError()) != cudaSuccess) return (int)c;
    j0 += n;
  }
  r.total = total;
  return wgrad_reduce(r, (const float*)part, s);
}
