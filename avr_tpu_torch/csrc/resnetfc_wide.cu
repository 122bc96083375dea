// K2's wide kernels: the forward and the dgrad for decoder shapes past the
// register-resident kernels' envelopes.  bf16 with d_hidden 256 to 1,024
// takes the TMA cluster kernels (resnetfc_wide_tma_fwd_kernel,
// resnetfc_wide_tma_dgrad_kernel), float32 with d_hidden 576 to 1,024 the
// float32 cluster kernels (resnetfc_wide_f32_fwd_kernel,
// resnetfc_wide_f32_dgrad_kernel; designs below), each where its shared
// memory fits; every other shape past the register kernels takes
// csrc/resnetfc_chain.cu's chain.
//
// Replaces, for those shapes, avr_tpu/ops/pallas/resnetfc.py's forward
// fused_resnetfc (:896, kernel call :726, stash outputs :637-653) and the
// dgrad half of its stash backward _bwd_stash_impl (:400-575, call :823);
// run per chunk as the stash forward into the chunk's workspace and the
// dgrad, the recompute backward _bwd_impl (:248-390, call :853).  The
// wgrads stay csrc/resnetfc_hopper.cu's (bf16) and csrc/resnetfc.cu's
// (float32), which take jobs of any width.  ops/kernels/resnetfc.py
// forward_route and backward_route send a shape here when it is past the
// other kernels' envelopes (d_hidden above 512 in either dtype: the
// register-resident trunks of resnetfc_fwd_wgmma_kernel,
// resnetfc_fwd_f32_kernel and both dgrads are full at 512; for the bf16
// dgrad, d_latent above 512 or more than 128 encoded input lanes: the dgrad
// tail's tiles) and inside these kernels' (wide_tma_fits, wide_f32_fits).
//
// A first version of these kernels (the float32 trunk in shared memory,
// the weights read from L2 a tile at a time) is retired: the chain ran the
// shapes it last took faster (chip_smoke.py --chain-sweep).  The numerics
// below are the ones it set.
//
// Numerics.  The forward adds each product into the float32 trunk in the
// register kernels' order (h = (h + acc) + b), so every rounding point is
// the register kernels' and the plain version's.  The dgrad walks a tile's
// chain in reverse with the rounding and mask order of the other dgrads
// (chip_smoke.py decoder_bwd_matched, csrc/resnetfc.cu
// resnetfc_dgrad_f32_kernel): lin_out's cotangent g_epi = g *
// act'(out_pre), rounded, to gout; gh = mask(relu(h_final)) * (g_epi @
// Wo); per block c1 = round(gh) (its cotangent slot), c0 = round(mask(
// relu(fc_0)) * (c1 @ W1)) (its slot), gh += mask(relu(h)) * (c0 @ W0);
// the pooled cotangent over NS > 1 as the walk pools it.  Its own tail per
// view: cot_in = round(gh) (its slot); d encoding = cot_in @ Wi in column
// chunks of at most d_hidden, summed onto dx through the encoding's cos
// lanes; the encoded input to enc; dz = sum over the injections j
// (ascending) of G_j @ Wz_j in one float32 sum, rounded once, as the bf16
// tail kernel forms it, with G_j the rounded cotangent rows this CTA
// stored.  No float atomics: every output has one writer and one order,
// the same bits on every run.
//
// The bf16 TMA cluster kernels (a redesign of the first version's bf16
// instantiations for Hopper).  wide_turns.py --probe on the first version at
// the band chunk (81,920 points, d_hidden 1,024, a latent of 1,152) found it
// bound by its weight stream: each 32-point tile reads all ~28 MB of bf16
// weights from L2 (72 GB a forward), its warps waited on those loads for
// 54% of a forward tile's cycles (mma.sync 15%, the trunk's conversion 8%),
// and the bare stream once a 32-point tile takes 12.4 ms by __ldg, 13.1 by
// bulk copies.  The same stream multicast over 2- or 4-CTA clusters takes
// 5.2-5.3 ms (with CTA-scope remote arrivals; at cluster scope they cost
// more than the multicast saves).  So:
//   - the trunk (gh in the dgrad) lives in registers: 8 consumer warps of
//     one CTA (32 points) each own the trunk columns of their 64-column
//     groups w and w + 8 (two at most: d_hidden <= 1,024), 128 floats a
//     thread in the mma.sync accumulator's layout;
//   - the shared memory that frees holds a ring of WT_STAGES weight stages
//     of WT_STAGE bytes (a pass's 512 output rows x 32 k, 64-byte swizzle)
//     and the A region (two d_hidden-wide swizzled bf16 tiles; the
//     forward's as wide as its widest operand);
//   - each stage is fetched once a cluster of WT_CLUSTER CTAs: a producer
//     warp's one thread walks the passes in the consumers' order
//     (wt_fwd_pass / wt_dgrad_pass) and issues its CTA's 128-row pieces by
//     TMA with .multicast::cluster; the consumer warps release a stage on a
//     local barrier, and the producer relays the release to every CTA of
//     the cluster (one CTA-scope remote arrival a CTA, off the consumers'
//     path) and refills the slot when the whole cluster released it (2
//     CTAs ran both kernels faster than 4 in trials on the card);
//   - an operand that is the trunk (relu(h), round(gh)) is formed once a
//     product into the first tile, a product's output (fc_0's, the masked
//     c0) goes to the second while the first is read, and ldmatrix reads
//     both; the latent and G_j rows are loaded whole into the A region;
//   - products by mma.sync m16n8k16 from shared memory: a wgmma tile is 64
//     rows, whose float32 trunk (64 x 1,024 floats) fits neither the
//     registers nor, beside its operands, shared memory;
//   - the dgrad's ReLU masks (prefetched into L2 a block ahead) are read 16
//     pairs a lane at a time in the epilogues.
// What holds them (wide_turns.py --probe's stamps of these kernels): the
// mma.sync products take about half of a forward tile's cycles and a third
// of a dgrad tile's; a ninth warp puts three warps on one scheduler, which
// caps a thread at 168 registers against the trunk's 128 and a pass's 64
// accumulators, so ptxas spills (~1 KB a thread, to L2: shared memory takes
// nearly all of L1).  Trials on the card that did not help, and were not
// kept: no producer warp (each warp issuing in turn, 255 registers: the
// issuing warps waited on the cluster's slowest release), setmaxnreg over
// a producer warpgroup, and the trunk's columns split over the cluster
// (each CTA half of them for its 32 points, the A tiles' halves exchanged
// through distributed shared memory: the spills stayed, the exchange and
// twice the CTAs cost more than they saved).
// Numerics as above: the same rounding points and order of additions into
// the trunk (h = (h + acc) + b; c1, c0, gh; dz one float32 sum rounded
// once), one writer per output, no atomics, the same bits on every run;
// only the mma k order within a product differs from the first version's.
// Bound: operations (2.33 ms at the band in bf16); chip_smoke.py phase 11
// times both kernels, and PERF.md records the readings with the card's name
// and power limit.
//
// The float32 cluster kernels (a redesign of the first version's float32
// instantiations for Hopper).  wide_turns.py --probe-f32 on the first
// version at the band chunk found both bound by their weight stream: each
// 16-point tile reads all 56.4 MB of float32 weights from L2 (289 GB a
// forward; the weights exceed the 50 MB L2, though the same stream over 40
// MB ran no faster), a tile's warps waited on those loads for 58% (forward)
// and 51% (dgrad) of their cycles, and the bare stream once a 16-point tile
// takes 39.4 ms by __ldg, 51.6-55.4 by bulk copies, 20.3-22.2 multicast
// over 2- or 4-CTA clusters: under the 34.4 ms FMA bound only with the
// multicast.  So:
//   - a CTA of WF_TM = 16 points keeps the float32 trunk (gh in the dgrad)
//     and one operand tile in shared memory (16 x (d_hidden + 4) floats
//     each, 65.8 KB at 1,024), and the rest of shared memory is a ring of
//     full-width weight slabs: WF_KS = 8 k rows of the product's (up to)
//     d_hidden output columns, 3 stages at 1,024, more at narrower widths;
//   - one producer thread walks the tile's products in the consumers' order
//     (wf_fwd_prod / wf_dgrad_prod) and fills each stage by bulk copies
//     multicast to the 2-CTA cluster (a slab of whole rows in one 16 KB
//     piece a CTA; a window's rows one a copy); each consumer warp releases
//     a stage with one CTA-scope arrival on every CTA's barrier, so the
//     producer refills the slot as soon as the cluster has read it (a trial
//     that relayed the releases through the producer, as the bf16 kernels
//     do, fed the ring more slowly);
//   - the forward's latent rows (1,152 lanes) are read into the operand
//     tile in chunks of d_hidden lanes, eight 16-byte loads a thread in
//     flight, as the dgrad's dz reads back its G_j (a first version copied
//     each tile's latent rows into every stage beside the weight slab: 16
//     small bulk copies a stage throttled the feed and the forward ran
//     slower);
//   - four consumer warps, a thread 16 points x 8 columns of a product
//     (1,024 columns): per 4 k eight 16-byte weight loads from the stage (a
//     warp's 32 column threads read 512 contiguous bytes of a row) and
//     sixteen 16-byte point-row loads of the operand tile (the same for
//     every lane) for 512 FMAs, up to 255 registers a thread (a trial at 8
//     points x 8 columns on eight warps, capped at 168 registers by the
//     producer warp, ran slower);
//   - relu(h) is copied into the operand tile once a block and fc_0's
//     output is written there when every warp has read it; in the dgrad
//     c1 = gh is read from the trunk and the masked c0 goes to the operand
//     tile; lin_in's and the latent's dgrad products (past d_hidden columns)
//     run in windows of d_hidden columns, the last at fewer points a thread
//     (wf_pt), dz summing the injections' products window by window with
//     each G_j read back into the operand tile.
// What holds them (wide_turns.py --probe-f32's stamps of these kernels, a
// consumer warp's cycles): the FMA loop 72% (forward) and 60% (dgrad),
// below the FMA pipe's rate, waiting for a stage 11% / 14%, and in the
// dgrad its tail and lin_out's backward.  The loop comes back to the
// 16-point tile, the most points whose float32 trunk and operand tile fit
// beside a ring: its operand rows are loads every lane of a warp makes
// alike, and the stage copies' writes share the shared memory's bandwidth
// with the loads (trials that halved either load or gave the ring a fourth
// stage, the trunk moved to device memory, gained little or lost).  Both
// beat the first version at every width they take, d_hidden 576 to 1,024,
// so ops/kernels/resnetfc.py wide_f32_fits routes every such float32 shape
// to them.
// Numerics were the first version's bit for bit: one FMA chain per output
// in k order, the same rounding points and additions into the trunk (h =
// (h + acc) + b; gh += acc where the mask is on), the windows of the first
// version's chunks, dz over the injections in order, one writer per output,
// no atomics (chip_smoke.py phase 11 holds them bit for bit on a rerun).
// Bound: operations (28.2 MFLOP a point at d_hidden 1,024, a latent of
// 1,152: 34.4 ms at the band at 67 TFLOP/s).

#include "hopper.cuh"
#include "resnetfc.cuh"

#include <type_traits>

namespace {

constexpr int SMEM_MAX = 232448;  // bytes of shared memory a Hopper block can use

__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

bool shape_ok(int N, int ns, int k_in, int d_latent, int d_hidden, int d_out, int n_blocks,
              int n_lin_z, int dtype) {
  return N >= 1 && ns >= 1 && d_hidden % 64 == 0 && d_hidden >= 64 && d_latent % 64 == 0 &&
         d_latent >= 64 && k_in % 64 == 0 && k_in >= 64 && d_out >= 1 && d_out <= GOUT_W &&
         n_lin_z >= 1 && n_lin_z <= n_blocks && (dtype == 0 || dtype == 1);
}


// ---------------------------------------------------------------------------
// bf16 on Hopper: weight stages by TMA, multicast over a cluster
// ---------------------------------------------------------------------------

constexpr int WT_TM = 32;          // points a CTA
constexpr int WT_CLUSTER = 2;      // CTAs a cluster: a weight stage crosses L2 once a cluster
constexpr int WT_CONSUMERS = 256;  // eight consumer warps
constexpr int WT_THREADS = 288;    // and a producer warp (one thread)
constexpr int WT_KS = 32;          // k of a stage: 64-byte weight rows, 64-byte swizzle
constexpr int WT_PASS = 512;       // output columns of a pass: 64 a consumer warp
constexpr int WT_PIECE = 128;      // weight rows of a TMA box
constexpr uint32_t WT_PIECE_BYTES = WT_PIECE * WT_KS * 2;  // 8 KB
constexpr uint32_t WT_STAGE = WT_PASS * WT_KS * 2;          // 32 KB
constexpr int WT_STAGES = 3;
constexpr uint32_t WT_BOX = WT_TM * 128;  // a {64 columns, 32 rows} box of the A region
constexpr int WT_DH_MIN = 256, WT_DH_MAX = 1024;  // a warp's trunk: at most two 64-column groups
constexpr int WT_BAR = 1;          // the consumers' named barrier

// Columns of the A region: the forward's widest operand beside two d_hidden
// tiles; the dgrad's two d_hidden tiles.
__host__ __device__ inline int wt_ka(int dh, int dl, int k_in, bool bwd) {
  int k = 2 * dh;
  if (!bwd && dl > k) k = dl;
  if (!bwd && k_in > k) k = k_in;
  return k;
}
__host__ __device__ inline size_t wt_smem(int dh, int dl, int k_in, bool bwd) {
  return (size_t)WT_STAGES * WT_STAGE + (size_t)WT_TM * wt_ka(dh, dl, k_in, bwd) * 2 +
         (size_t)WT_TM * GOUT_W * 4 + 3 * WT_STAGES * 8;
}
// The dgrad tail's d-encoding chunk: columns a chunk, float32 rows WT_CW + 4
// apart in the second d_hidden tile.
__host__ __device__ inline int wt_cw(int dh) { return (dh / 2 - 4) / 64 * 64; }

// The weights, boxes {32 k, 128 rows, 1} with a 64-byte swizzle: the forward
// reads them as nn.Linear keeps them, wi (dh, k_in), wz (n_lin_z, dh, dl),
// w0 and w1 (n_blocks, dh, dh); the dgrad their transposed copies, wi (k_in,
// dh), wz (n_lin_z, dl, dh), w0 and w1.
struct __align__(64) WtMaps {
  CUtensorMap wi, wz, w0, w1;
};

// A pass of a tile's walk: rows [row0, row0 + n) of matrix `mat` of
// weight w (0 wi, 1 wz, 2 w0, 3 w1), over K; its stages are K / WT_KS.
struct WtPassDesc {
  int w, mat, row0, n, K;
};

// The ring: full[s] completes when this CTA's producer armed it and every
// piece of the stage has landed; consumed[s] when this CTA's eight consumer
// warps released it; empty[s] when the producer of every CTA of the
// cluster relayed its CTA's release (one remote arrival a CTA, off the
// consumers' path).
struct WtRing {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* consumed;
  uint64_t* empty;
};

// The barriers' start; the cluster meets before any remote arrival or
// multicast.
__device__ __forceinline__ void wt_start(const WtRing& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < WT_STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.consumed[s], 8);
      mbar_init(&r.empty[s], WT_CLUSTER);
    }
    mbar_fence_init();
  }
  cluster_sync();
}

// The producer (one thread): every stage of the walk's `passes` passes
// (sched(p), in the consumers' order), each into slot j % WT_STAGES once
// the cluster released the stage before it there: this CTA's release
// relayed to every CTA, then the cluster's awaited; then this CTA's full
// barrier armed and its pieces (piece q from the CTA of rank q %
// WT_CLUSTER) multicast to the cluster.
template <class Sched>
__device__ __forceinline__ void wt_produce(const WtRing& r, const WtMaps& m, const Sched& sched,
                                           int passes) {
  const uint32_t rank = cluster_rank();
  uint32_t j = 0;
  for (int p = 0; p < passes; ++p) {
    const WtPassDesc d = sched(p);
    const CUtensorMap* map = d.w == 0 ? &m.wi : d.w == 1 ? &m.wz : d.w == 2 ? &m.w0 : &m.w1;
    const int pieces = (d.n + WT_PIECE - 1) / WT_PIECE;
    for (int kc = 0; kc < d.K; kc += WT_KS, ++j) {
      const int s = j % WT_STAGES;
      if (j >= WT_STAGES) {
        const uint32_t ph = ((j / WT_STAGES) - 1) & 1;
        mbar_wait(&r.consumed[s], ph);
        for (uint32_t q = 0; q < (uint32_t)WT_CLUSTER; ++q) mbar_arrive_cluster(&r.empty[s], q);
        mbar_wait(&r.empty[s], ph);
      }
      mbar_expect_tx(&r.full[s], pieces * WT_PIECE_BYTES);
      for (int q = (int)rank; q < pieces; q += WT_CLUSTER)
        tma_load_3d_multicast(r.ring + s * WT_STAGE + q * WT_PIECE_BYTES, map, &r.full[s], kc,
                              d.row0 + q * WT_PIECE, d.mat, (uint16_t)((1 << WT_CLUSTER) - 1));
    }
  }
}

// A warp's accumulator for 32 points x 64 columns: acc[mt][nt][i] is row
// 16 mt + g + 8 (i >> 1), column 8 nt + 2 t + (i & 1) of its group (lane =
// 4 g + t), the mma.sync m16n8 fragment.
typedef float WtAcc[2][8][4];

__device__ __forceinline__ void wt_zero(WtAcc& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// The consumers' pass: acc += A B over K, A the 32 x K operand from box
// a_box of the A region, B this warp's 64 rows of each stage (rows 64 warp
// .. of the pass).  Every warp waits on and releases every stage and
// computes only where `on` (its group lies inside the pass).
__device__ __forceinline__ void wt_pass(const WtRing& r, uint32_t& it, WtAcc& acc,
                                        const unsigned char* Areg, int a_box, int K, bool on) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int arow = lane & 15, acol = (lane >> 4) * 8;               // ldmatrix A: row, k offset
  const int bn = (lane & 7) + ((lane >> 4) << 3), bk = (lane >> 3) & 1;  // B: row, 16-byte chunk
  const unsigned char* A = Areg + a_box * WT_BOX;
  for (int kc = 0; kc < K; kc += WT_KS, ++it) {
    const int s = it % WT_STAGES;
    mbar_wait(&r.full[s], (it / WT_STAGES) & 1);
    if (on) {
      const unsigned char* B = r.ring + s * WT_STAGE + warp * 64 * 64;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(a[mt], A + swz_off(16 * mt + arow, kc + 16 * ks + acol, WT_BOX), false);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          // 64-byte swizzle: chunk c of row n at c ^ ((n >> 1) & 3)
          const int n = 16 * np + bn, c = 2 * ks + bk;
          uint32_t b[4];
          ldsm_x4(b, B + n * 64 + ((c ^ ((n >> 1) & 3)) << 4), false);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_m16n8k16(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma_m16n8k16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&r.consumed[s]);
  }
}

// bf16 pair (lo, hi) at row, column col (even) of the A region
__device__ __forceinline__ void wt_put2(unsigned char* Areg, int box, int row, int col, float lo,
                                        float hi) {
  *reinterpret_cast<uint32_t*>(Areg + box * WT_BOX + swz_off(row, col, WT_BOX)) = bf2(lo, hi);
}

// rows [0, nv) of the w-wide tile at box `box` -> device rows r0.. of dst
// (row stride w), 16-byte copies by the consumers
__device__ __forceinline__ void wt_rows_out(const unsigned char* Areg, int box, bf16* dst, int r0,
                                            int nv, int w) {
  const int nvec = w / 8;
  for (int idx = threadIdx.x; idx < nv * nvec; idx += WT_CONSUMERS) {
    const int rr = idx / nvec, cv = idx - rr * nvec;
    *reinterpret_cast<uint4*>(dst + (size_t)(r0 + rr) * w + cv * 8) =
        *reinterpret_cast<const uint4*>(Areg + box * WT_BOX + swz_off(rr, cv * 8, WT_BOX));
  }
}

// device rows [0, nv) of src (row stride w) -> the tile at box `box`, rows
// past nv zero; eight 16-byte loads a thread in flight
__device__ __forceinline__ void wt_rows_in(unsigned char* Areg, int box, const bf16* src, int nv,
                                           int w) {
  const int nvec = w / 8, total = WT_TM * nvec;
  for (int base = threadIdx.x; base < total; base += 8 * WT_CONSUMERS) {
    uint4 v[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int idx = base + b * WT_CONSUMERS, rr = idx / nvec, cv = idx - rr * nvec;
      v[b] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < total && rr < nv)
        v[b] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)rr * w + cv * 8));
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int idx = base + b * WT_CONSUMERS, rr = idx / nvec, cv = idx - rr * nvec;
      if (idx < total)
        *reinterpret_cast<uint4*>(Areg + box * WT_BOX + swz_off(rr, cv * 8, WT_BOX)) = v[b];
    }
  }
}

// The walks' passes, in the order the consumers take them (each product of
// N columns in passes of WT_PASS).  Forward: per view lin_in, then per
// injection k its latent product and block k's fc_0 and fc_1; then the
// pooled blocks' fc_0 and fc_1.
__host__ __device__ inline int wt_np(int dh) { return (dh + WT_PASS - 1) / WT_PASS; }
__device__ __forceinline__ int wt_fwd_passes(const FcArgs& a) {
  return wt_np(a.d_hidden) * (a.ns * (1 + 3 * a.n_lin_z) + 2 * (a.n_blocks - a.n_lin_z));
}
__device__ __forceinline__ WtPassDesc wt_fwd_pass(const FcArgs& a, int p) {
  const int np = wt_np(a.d_hidden), q = p / np, per_view = 1 + 3 * a.n_lin_z;
  WtPassDesc d;
  d.row0 = (p - q * np) * WT_PASS;
  d.n = min(WT_PASS, a.d_hidden - d.row0);
  d.K = a.d_hidden;
  if (q < a.ns * per_view) {
    const int r = q % per_view;
    if (r == 0) {
      d.w = 0;
      d.mat = 0;
      d.K = a.k_in;
    } else {
      d.w = 1 + (r - 1) % 3;
      d.mat = (r - 1) / 3;
      if (d.w == 1) d.K = a.d_latent;
    }
  } else {
    const int t = q - a.ns * per_view;
    d.w = 2 + (t & 1);
    d.mat = a.n_lin_z + t / 2;
  }
  return d;
}
// Dgrad: the pooled blocks from the last down (fc_1, then fc_0), then per
// view its blocks from n_lin_z - 1 down, lin_in's chunks of wt_cw columns,
// and dz's passes, each over the injections j.
__device__ __forceinline__ void wt_dgrad_shape(const FcBwdArgs& a, int& post, int& blocks,
                                               int& nce, int& per_view) {
  const int np = wt_np(a.d_hidden), cw = wt_cw(a.d_hidden);
  post = 2 * (a.n_blocks - a.n_lin_z) * np;
  blocks = 2 * a.n_lin_z * np;
  nce = (a.k_in + cw - 1) / cw;
  per_view = blocks + nce + (a.d_latent + WT_PASS - 1) / WT_PASS * a.n_lin_z;
}
__device__ __forceinline__ int wt_dgrad_passes(const FcBwdArgs& a) {
  int post, blocks, nce, per_view;
  wt_dgrad_shape(a, post, blocks, nce, per_view);
  return post + a.ns * per_view;
}
__device__ __forceinline__ WtPassDesc wt_dgrad_pass(const FcBwdArgs& a, int p) {
  const int dh = a.d_hidden, np = wt_np(dh), nlz = a.n_lin_z;
  int post, blocks, nce, per_view;
  wt_dgrad_shape(a, post, blocks, nce, per_view);
  WtPassDesc d;
  d.K = dh;
  int t, sp, k;
  if (p < post) {
    t = p / np;
    sp = p - t * np;
    k = a.n_blocks - 1 - t / 2;
  } else {
    const int pv = (p - post) % per_view;
    if (pv >= blocks) {
      const int e = pv - blocks;
      if (e < nce) {
        d.w = 0;
        d.mat = 0;
        d.row0 = e * wt_cw(dh);
        d.n = min(wt_cw(dh), a.k_in - d.row0);
      } else {
        d.w = 1;
        d.mat = (e - nce) % nlz;
        d.row0 = (e - nce) / nlz * WT_PASS;
        d.n = min(WT_PASS, a.d_latent - d.row0);
      }
      return d;
    }
    t = pv / np;
    sp = pv - t * np;
    k = nlz - 1 - t / 2;
  }
  d.w = (t & 1) ? 2 : 3;
  d.mat = k;
  d.row0 = sp * WT_PASS;
  d.n = min(WT_PASS, dh - d.row0);
  return d;
}

// bf16 pair's low and high values
__device__ __forceinline__ float bf_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf_hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// This lane's 16 pairs of a ReLU mask (the stash rows m, row stride dh) for
// m-tile mt of a pass's group at column cb: rows 16 mt + g (+ 8), columns
// cb + 8 nt + 2 t; zero past nv.  Loaded together: one round trip.
__device__ __forceinline__ void wt_mask16(const bf16* m, int dh, int nv, int mt, int cb,
                                          uint32_t (&mk)[8][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = 16 * mt + g + 8 * hi;
      mk[nt][hi] = row < nv ? __ldg(reinterpret_cast<const unsigned int*>(
                                  m + (size_t)row * dh + cb + 8 * nt + 2 * t))
                            : 0u;
    }
}

// The trunk in registers: a warp's groups w and w + 8 (columns 64 w .. and
// 512 + 64 w ..) of the 32 points, h[sp][mt][nt][i] in the accumulator's
// fragment layout; `on[sp]` where the group lies inside d_hidden.
typedef float WtTrunk[2][2][8][4];

#define WT_EACH(body)                                                      \
  _Pragma("unroll") for (int sp = 0; sp < 2; ++sp) {                      \
    if (!on[sp]) continue;                                                 \
    _Pragma("unroll") for (int mt = 0; mt < 2; ++mt)                      \
    _Pragma("unroll") for (int nt = 0; nt < 8; ++nt)                      \
    _Pragma("unroll") for (int hi = 0; hi < 2; ++hi) {                    \
      const int row = 16 * mt + g + 8 * hi;                                \
      const int col = WT_PASS * sp + 64 * warp + 8 * nt + 2 * t;           \
      float& e0 = h[sp][mt][nt][2 * hi];                                   \
      float& e1 = h[sp][mt][nt][2 * hi + 1];                               \
      body                                                                 \
    }                                                                      \
  }

// The same over one pass's accumulator (group base cb): x0, x1 the pair.
#define WT_ACC(acc, body)                                                  \
  _Pragma("unroll") for (int mt = 0; mt < 2; ++mt)                        \
  _Pragma("unroll") for (int nt = 0; nt < 8; ++nt)                        \
  _Pragma("unroll") for (int hi = 0; hi < 2; ++hi) {                      \
    const int row = 16 * mt + g + 8 * hi;                                  \
    const int col = cb + 8 * nt + 2 * t;                                   \
    const float x0 = acc[mt][nt][2 * hi], x1 = acc[mt][nt][2 * hi + 1];    \
    body                                                                   \
  }

// forward: a.wi, wz, w0, w1 bf16 as nn.Linear keeps them (through m); a.pool
// for NS > 1, WT_TM x dh floats a CTA of the grid
__global__ void __launch_bounds__(WT_THREADS, 1)
resnetfc_wide_tma_fwd_kernel(const __grid_constant__ FcArgs a, const __grid_constant__ WtMaps m) {
  extern __shared__ __align__(1024) unsigned char wt_shared[];
  const int dh = a.d_hidden, dl = a.d_latent, k_in = a.k_in, N = a.N, ns = a.ns;
  const int nb = a.n_blocks, nlz = a.n_lin_z;
  unsigned char* Areg = wt_shared + WT_STAGES * WT_STAGE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Areg + (size_t)WT_TM * wt_ka(dh, dl, k_in, false) * 2 +
                                               WT_TM * GOUT_W * 4);
  const WtRing r{wt_shared, bars, bars + WT_STAGES, bars + 2 * WT_STAGES};
  const int tid = threadIdx.x, warp = tid >> 5;
  wt_start(r);
  if (warp == 8) {
    if (tid == WT_CONSUMERS) wt_produce(r, m, [&](int p) { return wt_fwd_pass(a, p); },
                                        wt_fwd_passes(a));
    __syncwarp();
  } else {
    uint32_t it = 0;  // the stage the consumers take next
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = blockIdx.x * WT_TM, nv = max(0, min(WT_TM, N - r0));
    const bool on[2] = {64 * warp < dh, WT_PASS + 64 * warp < dh};
    const int A2 = dh / 64;  // box of the second d_hidden tile (the first is box 0)
    bf16* stash = static_cast<bf16*>(a.stash);
    const size_t slot = (size_t)N * dh;
    float* pool = a.pool + (size_t)blockIdx.x * WT_TM * dh;
    if (tid == 0 && nv > 0)  // the tile's latent rows, read once an injection
      for (int v = 0; v < ns; ++v)
        bulk_prefetch_l2(static_cast<const bf16*>(a.z) + ((size_t)v * N + r0) * dl,
                         (uint32_t)(nv * dl * 2));
    WtTrunk h;
    WtAcc acc;
    // a product of N = dh columns: per pass sp, acc = A B, then epi on
    // (this warp's group of the pass, its trunk group h[sp], column base cb)
    auto product = [&](int a_box, int K, auto&& epi) {
      wt_zero(acc);
      wt_pass(r, it, acc, Areg, a_box, K, on[0]);
      if (on[0]) epi(h[0], 64 * warp);
      if (dh > WT_PASS) {
        wt_zero(acc);
        wt_pass(r, it, acc, Areg, a_box, K, on[1]);
        if (on[1]) epi(h[1], WT_PASS + 64 * warp);
      }
    };
    // h = h + relu(relu(h) @ W0 + b0) @ W1 + b1, the two activations to the
    // stash when it is kept: relu(h) formed once into the first tile, fc_0's
    // output into the second
    auto block = [&](int k, int v) {
      named_sync(WT_BAR, WT_CONSUMERS);  // every warp is done reading the A region
      WT_EACH(wt_put2(Areg, 0, row, col, relu(e0), relu(e1));)
      named_sync(WT_BAR, WT_CONSUMERS);
      if (stash) wt_rows_out(Areg, 0, stash + stash_slot(k, 0, v, ns, nlz) * slot, r0, nv, dh);
      const float* b0 = a.b0 + (size_t)k * dh;
      product(0, dh, [&](float (&)[2][8][4], int cb) {
        WT_ACC(acc, {
          const float2 b = __ldg(reinterpret_cast<const float2*>(b0 + col));
          wt_put2(Areg, A2, row, col, relu(x0 + b.x), relu(x1 + b.y));
        })
      });
      named_sync(WT_BAR, WT_CONSUMERS);
      if (stash) wt_rows_out(Areg, A2, stash + stash_slot(k, 1, v, ns, nlz) * slot, r0, nv, dh);
      const float* b1 = a.b1 + (size_t)k * dh;
      product(A2, dh, [&](float (&hs)[2][8][4], int cb) {
        WT_ACC(acc, {
          const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + col));
          hs[mt][nt][2 * hi] = (hs[mt][nt][2 * hi] + x0) + b.x;
          hs[mt][nt][2 * hi + 1] = (hs[mt][nt][2 * hi + 1] + x1) + b.y;
        })
      });
    };

    for (int v = 0; v < ns; ++v) {
      named_sync(WT_BAR, WT_CONSUMERS);  // the previous view is done with the A region
      for (int idx = tid; idx < WT_TM * k_in; idx += WT_CONSUMERS) {
        const int rr = idx / k_in, j = idx - rr * k_in, row = r0 + rr;
        const int mode = a.tables[j];
        float val = 0.f;
        if (row < N && mode != 2) {
          const float p = a.x[((size_t)v * N + row) * a.d_in + a.tables[k_in + j]];
          val = mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[k_in + j]));
        }
        *reinterpret_cast<bf16*>(Areg + swz_off(rr, j, WT_BOX)) = from_f<bf16>(val);
      }
      named_sync(WT_BAR, WT_CONSUMERS);
      product(0, k_in, [&](float (&hs)[2][8][4], int cb) {
        WT_ACC(acc, {
          const float2 b = __ldg(reinterpret_cast<const float2*>(a.bi + col));
          hs[mt][nt][2 * hi] = x0 + b.x;
          hs[mt][nt][2 * hi + 1] = x1 + b.y;
        })
      });
      for (int k = 0; k < nlz; ++k) {
        named_sync(WT_BAR, WT_CONSUMERS);
        wt_rows_in(Areg, 0, static_cast<const bf16*>(a.z) + ((size_t)v * N + r0) * dl, nv, dl);
        named_sync(WT_BAR, WT_CONSUMERS);
        const float* bz = a.bz + (size_t)k * dh;
        product(0, dl, [&](float (&hs)[2][8][4], int cb) {
          WT_ACC(acc, {
            const float2 b = __ldg(reinterpret_cast<const float2*>(bz + col));
            hs[mt][nt][2 * hi] = (hs[mt][nt][2 * hi] + x0) + b.x;
            hs[mt][nt][2 * hi + 1] = (hs[mt][nt][2 * hi + 1] + x1) + b.y;
          })
        });
        block(k, v);
      }
      if (ns > 1) {  // each thread its own pool entries
        WT_EACH({
          float* p = pool + row * dh + col;
          p[0] = v == 0 ? e0 : p[0] + e0;
          p[1] = v == 0 ? e1 : p[1] + e1;
        })
      }
    }
    if (ns > 1) {
      const float inv = 1.f / (float)ns;
      WT_EACH({
        const float* p = pool + row * dh + col;
        e0 = p[0] * inv;
        e1 = p[1] * inv;
      })
    }
    for (int k = nlz; k < nb; ++k) block(k, 0);

    // relu -> lin_out (one thread a (point, output), as the first version)
    named_sync(WT_BAR, WT_CONSUMERS);
    WT_EACH(wt_put2(Areg, 0, row, col, relu(e0), relu(e1));)
    named_sync(WT_BAR, WT_CONSUMERS);
    if (stash)
      wt_rows_out(Areg, 0, stash + (size_t)(stash_slots(ns, nb, nlz) - 1) * slot, r0, nv, dh);
    const bf16* wo = static_cast<const bf16*>(a.wo);
    for (int idx = tid; idx < WT_TM * a.d_out; idx += WT_CONSUMERS) {
      const int rr = idx / a.d_out, o = idx - rr * a.d_out;
      if (rr >= nv) continue;
      const bf16* wrow = wo + (size_t)o * dh;
      float s = 0.f;
      for (int k = 0; k < dh; k += 8) {
        const uint4 q = *reinterpret_cast<const uint4*>(Areg + swz_off(rr, k, WT_BOX));
        const bf16* e = reinterpret_cast<const bf16*>(&q);
#pragma unroll
        for (int j = 0; j < 8; ++j) s = fmaf(to_f(e[j]), to_f(__ldg(wrow + k + j)), s);
      }
      s = s + a.bo[o];
      if (a.activate) s = o < 3 ? sigmoidf_(s) : fmaxf(s, 0.f);
      a.out[(size_t)(r0 + rr) * a.d_out + o] = s;
    }
  }
  cluster_sync();  // no CTA leaves while the cluster's arrivals may still reach it
}

// dgrad: a.wi, wz, w0, w1 the bf16 transposed copies (through m); a.pool for
// NS > 1, WT_TM x dh floats a CTA of the grid
__global__ void __launch_bounds__(WT_THREADS, 1)
resnetfc_wide_tma_dgrad_kernel(const __grid_constant__ FcBwdArgs a,
                               const __grid_constant__ WtMaps m) {
  extern __shared__ __align__(1024) unsigned char wt_shared[];
  const int dh = a.d_hidden, dl = a.d_latent, k_in = a.k_in, N = a.N, ns = a.ns;
  const int nb = a.n_blocks, nlz = a.n_lin_z, cw = wt_cw(dh);
  unsigned char* Areg = wt_shared + WT_STAGES * WT_STAGE;
  float* gs = reinterpret_cast<float*>(Areg + (size_t)WT_TM * wt_ka(dh, dl, k_in, true) * 2);
  uint64_t* bars = reinterpret_cast<uint64_t*>(gs + WT_TM * GOUT_W);
  const WtRing r{wt_shared, bars, bars + WT_STAGES, bars + 2 * WT_STAGES};
  const int tid = threadIdx.x, warp = tid >> 5;
  wt_start(r);
  if (warp == 8) {
    if (tid == WT_CONSUMERS) wt_produce(r, m, [&](int p) { return wt_dgrad_pass(a, p); },
                                        wt_dgrad_passes(a));
    __syncwarp();
  } else {
    uint32_t it = 0;  // the stage the consumers take next
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = blockIdx.x * WT_TM, nv = max(0, min(WT_TM, N - r0));
    const bool on[2] = {64 * warp < dh, WT_PASS + 64 * warp < dh};
    const int A2 = dh / 64;
    const bf16* stash = static_cast<const bf16*>(a.stash);
    bf16* cot = static_cast<bf16*>(a.cot);
    const size_t slot = (size_t)N * dh;
    const bf16* aout = stash + (size_t)(stash_slots(ns, nb, nlz) - 1) * slot;
    const bf16* wo = static_cast<const bf16*>(a.wo);
    float* pool = a.pool + (size_t)blockIdx.x * WT_TM * dh;
    WtTrunk h;  // the trunk cotangent gh
    WtAcc acc;
    auto product = [&](int a_box, auto&& epi) {
      wt_zero(acc);
      wt_pass(r, it, acc, Areg, a_box, dh, on[0]);
      if (on[0]) epi(h[0], 64 * warp);
      if (dh > WT_PASS) {
        wt_zero(acc);
        wt_pass(r, it, acc, Areg, a_box, dh, on[1]);
        if (on[1]) epi(h[1], WT_PASS + 64 * warp);
      }
    };

    if (tid == 0 && nv > 0) bulk_prefetch_l2(aout + (size_t)r0 * dh, (uint32_t)(nv * dh * 2));
    // lin_out: g_epi = g * act'(out_pre), rounded (0 past d_out), to gout
    for (int idx = tid; idx < WT_TM * GOUT_W; idx += WT_CONSUMERS) {
      const int rr = idx / GOUT_W, o = idx - rr * GOUT_W, row = r0 + rr;
      float gv = 0.f;
      if (row < N && o < a.d_out) {
        gv = a.g[(size_t)row * a.d_out + o];
        if (a.activate) {
          const bf16* arow = aout + (size_t)row * dh;
          const bf16* wrow = wo + (size_t)o * dh;
          float sum = 0.f;
          for (int k = 0; k < dh; k += 8) {
            bf16 av[8], wv[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              av[j] = __ldg(arow + k + j);
              wv[j] = __ldg(wrow + k + j);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) sum = fmaf(to_f(av[j]), to_f(wv[j]), sum);
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
      gs[idx] = gv;
      if (row < N) static_cast<bf16*>(a.gout)[(size_t)row * GOUT_W + o] = from_f<bf16>(gv);
    }
    named_sync(WT_BAR, WT_CONSUMERS);
    // gh = mask(relu(h_final)) * (g_epi @ Wo), each thread its own entries;
    // an 8-column group's Wo pairs and stash pairs read together
#pragma unroll
    for (int sp = 0; sp < 2; ++sp) {
      if (!on[sp]) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = WT_PASS * sp + 64 * warp + 8 * nt + 2 * t;
        uint32_t wv[GOUT_W], mk[2][2];
#pragma unroll
        for (int o = 0; o < GOUT_W; ++o)
          wv[o] = o < a.d_out
                      ? __ldg(reinterpret_cast<const unsigned int*>(wo + (size_t)o * dh + col))
                      : 0u;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int pr = r0 + 16 * mt + g + 8 * hi;
            mk[mt][hi] = pr < N ? __ldg(reinterpret_cast<const unsigned int*>(
                                      aout + (size_t)pr * dh + col))
                                : 0u;
          }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int row = 16 * mt + g + 8 * hi;
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int o = 0; o < GOUT_W; ++o)
              if (o < a.d_out) {
                s0 = fmaf(gs[row * GOUT_W + o], bf_lo(wv[o]), s0);
                s1 = fmaf(gs[row * GOUT_W + o], bf_hi(wv[o]), s1);
              }
            h[sp][mt][nt][2 * hi] = bf_lo(mk[mt][hi]) > 0.f ? s0 : 0.f;
            h[sp][mt][nt][2 * hi + 1] = bf_hi(mk[mt][hi]) > 0.f ? s1 : 0.f;
          }
      }
    }

    // block k of view v, backward: c1 = round(gh) (formed once into the
    // first tile); c0 = round(mask(relu(fc_0)) * (c1 @ W1)) into the second;
    // gh += mask(relu(h)) * (c0 @ W0)
    auto block = [&](int k, int v) {
      if (tid == 0 && nv > 0)  // the block's two ReLU masks: read in its products' epilogues
        for (int j = 0; j < 2; ++j)
          bulk_prefetch_l2(stash + stash_slot(k, j, v, ns, nlz) * slot + (size_t)r0 * dh,
                           (uint32_t)(nv * dh * 2));
      named_sync(WT_BAR, WT_CONSUMERS);  // every warp is done reading the A region
      WT_EACH(wt_put2(Areg, 0, row, col, e0, e1);)
      named_sync(WT_BAR, WT_CONSUMERS);
      wt_rows_out(Areg, 0, cot + stash_slot(k, 1, v, ns, nlz) * slot, r0, nv, dh);
      const bf16* m1 = stash + stash_slot(k, 1, v, ns, nlz) * slot + (size_t)r0 * dh;
      product(0, [&](float (&)[2][8][4], int cb) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t mk[8][2];
          wt_mask16(m1, dh, nv, mt, cb, mk);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi)
              wt_put2(Areg, A2, 16 * mt + g + 8 * hi, cb + 8 * nt + 2 * t,
                      bf_lo(mk[nt][hi]) > 0.f ? acc[mt][nt][2 * hi] : 0.f,
                      bf_hi(mk[nt][hi]) > 0.f ? acc[mt][nt][2 * hi + 1] : 0.f);
        }
      });
      named_sync(WT_BAR, WT_CONSUMERS);
      wt_rows_out(Areg, A2, cot + stash_slot(k, 0, v, ns, nlz) * slot, r0, nv, dh);
      const bf16* m0 = stash + stash_slot(k, 0, v, ns, nlz) * slot + (size_t)r0 * dh;
      product(A2, [&](float (&hs)[2][8][4], int cb) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t mk[8][2];
          wt_mask16(m0, dh, nv, mt, cb, mk);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              if (bf_lo(mk[nt][hi]) > 0.f) hs[mt][nt][2 * hi] += acc[mt][nt][2 * hi];
              if (bf_hi(mk[nt][hi]) > 0.f) hs[mt][nt][2 * hi + 1] += acc[mt][nt][2 * hi + 1];
            }
        }
      });
    };

    // the view's tail: cot_in, dx and enc through lin_in's backward, dz
    auto tail = [&](int v) {
      named_sync(WT_BAR, WT_CONSUMERS);
      WT_EACH(wt_put2(Areg, 0, row, col, e0, e1);)
      named_sync(WT_BAR, WT_CONSUMERS);
      const int ci = cot_in_slot(v, ns, nb, nlz);
      wt_rows_out(Areg, 0, cot + ci * slot, r0, nv, dh);
      // d encoding = cot_in @ Wi in chunks of cw columns, float32 into the
      // second tile (rows cw + 4 apart), each summed onto dx
      float* Es = reinterpret_cast<float*>(Areg + A2 * WT_BOX);
      const int lde = cw + 4;
      for (int c0 = 0; c0 < k_in; c0 += cw) {
        const int w = min(cw, k_in - c0);
        wt_zero(acc);
        wt_pass(r, it, acc, Areg, 0, dh, 64 * warp < w);
        if (64 * warp < w) {
          const int cb = 64 * warp;
          WT_ACC(acc, {
            Es[row * lde + col] = x0;
            Es[row * lde + col + 1] = x1;
          })
        }
        named_sync(WT_BAR, WT_CONSUMERS);
        for (int idx = tid; idx < WT_TM * a.d_in; idx += WT_CONSUMERS) {
          const int rr = idx / a.d_in, ln = idx - rr * a.d_in, row = r0 + rr;
          if (row >= N) continue;
          const size_t at = ((size_t)v * N + row) * a.d_in + ln;
          const float p = a.x[at];
          float sum = c0 == 0 ? 0.f : a.dx[at];
          for (int jj = 0; jj < w; ++jj) {
            const int j = c0 + jj, mode = a.tables[j];
            if (mode == 2 || a.tables[k_in + j] != ln) continue;
            float d = Es[rr * lde + jj];
            if (mode == 1)
              d = d * (cosf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[k_in + j])) * a.fph[j]);
            sum += d;
          }
          a.dx[at] = sum;
        }
        named_sync(WT_BAR, WT_CONSUMERS);  // the chunk is read before the next one is written
      }
      bf16* enc = static_cast<bf16*>(a.enc) + (size_t)v * N * k_in;
      for (int idx = tid; idx < WT_TM * k_in; idx += WT_CONSUMERS) {
        const int rr = idx / k_in, j = idx - rr * k_in, row = r0 + rr;
        if (row >= N) continue;
        const int mode = a.tables[j];
        float val = 0.f;
        if (mode != 2) {
          const float p = a.x[((size_t)v * N + row) * a.d_in + a.tables[k_in + j]];
          val = mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[k_in + j]));
        }
        enc[(size_t)row * k_in + j] = from_f<bf16>(val);
      }
      // dz = sum over j of G_j @ Wz_j, one float32 sum, rounded once; G_0 =
      // cot_in (the first tile), G_j the rows this CTA stored for block j -
      // 1's c1, read back into the second tile
      bf16* dz = static_cast<bf16*>(a.dz) + (size_t)v * N * dl;
      for (int p0 = 0; p0 < dl; p0 += WT_PASS) {
        const bool live = 64 * warp < min(WT_PASS, dl - p0);
        wt_zero(acc);
        for (int j = 0; j < nlz; ++j) {
          if (j > 0) {
            named_sync(WT_BAR, WT_CONSUMERS);
            wt_rows_in(Areg, A2, cot + stash_slot(j - 1, 1, v, ns, nlz) * slot + (size_t)r0 * dh,
                       nv, dh);
            named_sync(WT_BAR, WT_CONSUMERS);
          }
          wt_pass(r, it, acc, Areg, j == 0 ? 0 : A2, dh, live);
        }
        if (live) {
          const int cb = p0 + 64 * warp;
          WT_ACC(acc, {
            if (row < nv)
              *reinterpret_cast<__nv_bfloat162*>(dz + (size_t)(r0 + row) * dl + col) =
                  __floats2bfloat162_rn(x0, x1);
          })
        }
      }
    };

    // the pooled blocks (all of them at NS 1), then per view its blocks from
    // gh = the pooled cotangent / NS
    for (int k = nb - 1; k >= nlz; --k) block(k, 0);
    if (ns > 1) {
      WT_EACH({
        float* p = pool + row * dh + col;
        p[0] = e0;
        p[1] = e1;
      })
    }
    const float inv_ns = 1.f / (float)ns;
    for (int v = 0; v < ns; ++v) {
      if (ns > 1) {
        WT_EACH({
          const float* p = pool + row * dh + col;
          e0 = p[0] * inv_ns;
          e1 = p[1] * inv_ns;
        })
      }
      for (int k = nlz - 1; k >= 0; --k) block(k, v);
      tail(v);
    }
  }
  cluster_sync();
}

#undef WT_EACH
#undef WT_ACC

// One weight's tensor map: n matrices of rows x cols bf16, boxes {32, 128, 1}.
int wt_map(CUtensorMap* m, const void* base, int n, int rows, int cols) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)n};
  const uint64_t strides[2] = {(uint64_t)cols * 2, (uint64_t)rows * cols * 2};
  const uint32_t box[3] = {(uint32_t)WT_KS, (uint32_t)WT_PIECE, 1u};
  return make_tensor_map(m, base, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

// A cluster launch of WT_CLUSTER CTAs a cluster over every 32-point tile
// (the grid rounded up to whole clusters); returns cudaLaunchKernelEx's
// error, or the launch's.
template <typename Args>
int wt_launch(void (*kernel)(Args, WtMaps), const Args& a, const WtMaps& m, size_t smem,
              cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (a.N + WT_TM - 1) / WT_TM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((tiles + WT_CLUSTER - 1) / WT_CLUSTER * WT_CLUSTER));
  cfg.blockDim = dim3(WT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = WT_CLUSTER;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a, m);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

bool wt_shape_ok(int N, int ns, int k_in, int d_latent, int d_hidden, int d_out, int n_blocks,
                 int n_lin_z, bool bwd) {
  return shape_ok(N, ns, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z, 1) &&
         d_hidden >= WT_DH_MIN && d_hidden <= WT_DH_MAX &&
         wt_smem(d_hidden, d_latent, k_in, bwd) <= (size_t)SMEM_MAX;
}

// ---------------------------------------------------------------------------
// float32 on Hopper: full-width weight slabs by bulk copies, multicast over a
// cluster; 16 x 8 register-tiled FMA from shared memory
// ---------------------------------------------------------------------------

constexpr int WF_TM = 16;          // points a CTA
constexpr int WF_KS = 8;           // weight rows (k) of a stage
constexpr int WF_CLUSTER = 2;      // CTAs a cluster: a stage crosses L2 once a cluster
constexpr int WF_STAGES_MIN = 3, WF_STAGES_MAX = 8;
constexpr int WF_CONSUMERS = 128;  // four consumer warps: 16 points x 8 columns a thread
constexpr int WF_THREADS = 160;    // and a producer warp (one thread)
constexpr int WF_DH_MAX = 1024;    // a product's 1,024 columns: 8 a consumer thread
constexpr int WF_BAR = 1;          // the consumers' named barrier

// Shared memory: the ring (a stage: WF_KS weight rows of at most d_hidden
// columns), the trunk Hs (WF_TM
// rows of d_hidden + 4 floats), the operand tile As (WF_TM rows of wf_lda),
// g_epi (WF_TM x GOUT_W) and the ring's two barriers a stage.
__host__ __device__ inline int wf_lda(int dh, int k_in) { return (dh > k_in ? dh : k_in) + 4; }
__host__ __device__ inline int wf_stage_floats(int dh) { return WF_KS * dh; }
__host__ __device__ inline size_t wf_fixed(int dh, int k_in) {
  return 4 * ((size_t)WF_TM * (dh + 4) + (size_t)WF_TM * wf_lda(dh, k_in) + WF_TM * GOUT_W) +
         2 * WF_STAGES_MAX * 8;
}
// stages of the ring: as many as fit, at most WF_STAGES_MAX
__host__ __device__ inline int wf_stages(int dh, int k_in) {
  const long long room = (long long)SMEM_MAX - (long long)wf_fixed(dh, k_in);
  const long long s = room / (4ll * wf_stage_floats(dh));
  return s > WF_STAGES_MAX ? WF_STAGES_MAX : (s < 0 ? 0 : (int)s);
}
__host__ __device__ inline size_t wf_smem(int dh, int k_in) {
  return (size_t)wf_stages(dh, k_in) * 4 * wf_stage_floats(dh) + wf_fixed(dh, k_in);
}
// points a thread in a product `cw` columns wide: the fewest (1, 2, 4, 8,
// 16) whose 16 / PT point sets of 8 PT threads x 8 columns cover it
__host__ __device__ inline int wf_pt(int cw) {
  int pt = 1;
  while (pt < 16 && 64 * pt < cw) pt *= 2;
  return pt;
}

// A product's weights in the walk: K rows (ldw apart) of matrix w, its
// columns [cb, cb + cw).
struct WfProd {
  const float* w;
  int ldw, K, cb, cw;
};

struct WfRing {
  float* ring;        // stage s at ring + s * stage
  int stage, stages;  // floats a stage, stages
  float* Hs;
  float* As;
  float* gs;
  uint64_t* full;     // this CTA's producer armed it and every row landed
  uint64_t* empty;    // every consumer warp of the cluster released it
};

__device__ __forceinline__ WfRing wf_ring(unsigned char* smem, int dh, int k_in, int stages) {
  WfRing r;
  r.ring = reinterpret_cast<float*>(smem);
  r.stage = wf_stage_floats(dh);
  r.stages = stages;
  r.Hs = r.ring + (size_t)stages * r.stage;
  r.As = r.Hs + WF_TM * (dh + 4);
  r.gs = r.As + WF_TM * wf_lda(dh, k_in);
  r.full = reinterpret_cast<uint64_t*>(r.gs + WF_TM * GOUT_W);
  r.empty = r.full + WF_STAGES_MAX;
  return r;
}

// The barriers' start; the cluster meets before any remote arrival or
// multicast.
__device__ __forceinline__ void wf_start(const WfRing& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], WF_CONSUMERS / 32 * WF_CLUSTER);
    }
    mbar_fence_init();
  }
  cluster_sync();
}

// The producer (one thread): every slab of the walk's `prods` products
// (sched(p), in the consumers' order), slab j into slot j % stages once
// every consumer warp of the cluster released the slot; its weight rows
// multicast to the cluster (a slab of whole rows, contiguous, in one piece
// a CTA; a window's rows one a copy, row q from the CTA of rank q %
// WF_CLUSTER).
template <class Sched>
__device__ __forceinline__ void wf_produce(const WfRing& r, const Sched& sched, int prods) {
  const uint32_t rank = cluster_rank();
  const uint16_t mask = (uint16_t)((1 << WF_CLUSTER) - 1);
  uint32_t j = 0;
  for (int p = 0; p < prods; ++p) {
    const WfProd d = sched(p);
    for (int k0 = 0; k0 < d.K; k0 += WF_KS, ++j) {
      const int s = (int)(j % (uint32_t)r.stages);
      if (j >= (uint32_t)r.stages) mbar_wait(&r.empty[s], (j / r.stages - 1) & 1);
      mbar_expect_tx(&r.full[s], (uint32_t)(WF_KS * d.cw * 4));
      float* st = r.ring + (size_t)s * r.stage;
      if (d.cw == d.ldw) {  // whole rows: the slab is contiguous, a piece a CTA
        constexpr int RQ = WF_KS / WF_CLUSTER;
        bulk_load_multicast(st + rank * RQ * d.cw, d.w + (size_t)(k0 + rank * RQ) * d.ldw,
                            (uint32_t)(RQ * d.cw * 4), &r.full[s], mask);
      } else {
        for (int q = (int)rank; q < WF_KS; q += WF_CLUSTER)
          bulk_load_multicast(st + q * d.cw, d.w + (size_t)(k0 + q) * d.ldw + d.cb,
                              (uint32_t)(d.cw * 4), &r.full[s], mask);
      }
    }
  }
}

// A consumer thread's outputs in a product cw columns wide, PT points a
// thread: T = 8 PT threads a point set, tp = thread / T its set (points tp
// + (16 / PT) i, i < PT), tc = thread % T its 8 columns c0 .. c0 + 3 and c1
// .. c1 + 3 (c0 = 4 tc, c1 = cw / 2 + 4 tc); `on` where they lie inside
// the product.  At PT 16 (every product d_hidden wide) a warp's B loads read
// 32 contiguous 16-byte groups of a weight row and its A loads one point
// row, the same for every lane.
struct WfMap {
  int tp, c0, c1;
  bool on;
};
template <int PT>
__device__ __forceinline__ WfMap wf_map(int cw) {
  constexpr int T = 8 * PT;
  const int tc = threadIdx.x % T;
  return WfMap{(int)threadIdx.x / T, 4 * tc, cw / 2 + 4 * tc, tc < cw / 8};
}

// acc += A (the thread's PT points x WF_KS k, rows lda floats apart) W (WF_KS
// x its 8 columns, rows cw floats apart): per 4 k, eight 16-byte weight
// loads and PT 16-byte point-row loads (8 points at a time) for 32 PT FMAs.
// Each output one FMA chain in k order.
template <int PT>
__device__ __forceinline__ void wf_fma(const float* A, int lda, const float* W, int cw,
                                       const WfMap& m, float (&acc)[PT][8]) {
  constexpr int S = 16 / PT, H = PT > 8 ? 8 : PT;
#pragma unroll
  for (int k4 = 0; k4 < WF_KS; k4 += 4) {
    float4 b[8];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      b[2 * kk] = *reinterpret_cast<const float4*>(W + (k4 + kk) * cw + m.c0);
      b[2 * kk + 1] = *reinterpret_cast<const float4*>(W + (k4 + kk) * cw + m.c1);
    }
#pragma unroll
    for (int h0 = 0; h0 < PT; h0 += H) {
      float4 a[H];
#pragma unroll
      for (int i = 0; i < H; ++i)
        a[i] = *reinterpret_cast<const float4*>(A + (m.tp + S * (h0 + i)) * lda + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = b[2 * kk], b1 = b[2 * kk + 1];
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[h0 + i][j] = fmaf(av, bv[j], acc[h0 + i][j]);
        }
      }
    }
  }
}

template <int PT>
__device__ __forceinline__ void wf_zero(float (&acc)[PT][8]) {
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// The consumers' product: acc += A B over the next K / WF_KS slabs of the
// ring, A the shared tile A (its columns from 0).  Every warp waits on
// every slab and releases it to every CTA of the cluster (one CTA-scope
// arrival each).
template <int PT>
__device__ __forceinline__ void wf_run(const WfRing& r, uint32_t& it, int K, int cw,
                                       const float* A, int lda, const WfMap& m,
                                       float (&acc)[PT][8]) {
  for (int k0 = 0; k0 < K; k0 += WF_KS, ++it) {
    const int s = (int)(it % (uint32_t)r.stages);
    mbar_wait(&r.full[s], (it / r.stages) & 1);
    const float* st = r.ring + (size_t)s * r.stage;
    if (m.on) wf_fma<PT>(A + k0, lda, st, cw, m, acc);
    __syncwarp();
    if ((threadIdx.x & 31) < WF_CLUSTER) mbar_arrive_cluster(&r.empty[s], threadIdx.x & 31);
  }
}

// float4 of row `row`, column col of a float tile / bias
__device__ __forceinline__ float4& f4(float* p, int row, int ld, int col) {
  return *reinterpret_cast<float4*>(p + row * ld + col);
}
__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w));
}
// a thread's outputs (PT 16 in a dh-wide product): f(row, column, acc of
// its 4 columns (acc + q .. q + 3 of point i)) for each point i and each
// half q
#define WF_OWN(body)                                                        \
  {                                                                        \
    _Pragma("unroll") for (int i = 0; i < 16; ++i)                         \
    _Pragma("unroll") for (int q = 0; q < 8; q += 4) {                     \
      const int row = i, col = q ? m.c1 : m.c0;                            \
      const float* ac = acc[i] + q;                                        \
      body                                                                 \
    }                                                                      \
  }

// device rows [0, nv) of src (row stride lds), w columns -> the tile dst
// (row stride ld), rows past nv zero; eight 16-byte loads a thread in
// flight.  By the consumers.
__device__ __forceinline__ void wf_rows_in(const float* src, size_t lds, float* dst, int ld,
                                           int nv, int w, int nc) {
  const int nvec = w / 4, total = WF_TM * nvec;
  for (int base = threadIdx.x; base < total; base += 8 * nc) {
    float4 v[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int idx = base + b * nc, rr = idx / nvec, c = 4 * (idx - rr * nvec);
      v[b] = idx < total && rr < nv ? *reinterpret_cast<const float4*>(src + rr * lds + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int idx = base + b * nc, rr = idx / nvec, c = 4 * (idx - rr * nvec);
      if (idx < total) *reinterpret_cast<float4*>(dst + rr * ld + c) = v[b];
    }
  }
}

// tile rows [0, WF_TM) of src (row stride lds, w columns) -> device rows
// r0.. of dst (row stride w) below nv, relu'd when RELU; into the tile
// dst2 (row stride ld2) too where given, all rows.  By the consumers.
template <bool RELU>
__device__ __forceinline__ void wf_rows(const float* src, int lds, float* dst, int r0, int nv,
                                        int w, float* dst2, int ld2, int nc) {
  const int nvec = w / 4;
  for (int idx = threadIdx.x; idx < WF_TM * nvec; idx += nc) {
    const int rr = idx / nvec, c = 4 * (idx - rr * nvec);
    float4 v = *reinterpret_cast<const float4*>(src + rr * lds + c);
    if (RELU) v = relu4(v);
    if (dst2) *reinterpret_cast<float4*>(dst2 + rr * ld2 + c) = v;
    if (dst && rr < nv) *reinterpret_cast<float4*>(dst + (size_t)(r0 + rr) * w + c) = v;
  }
}

// The walks, in the order the consumers take the products.  Forward: per
// view lin_in, then per injection k its latent product and block k's fc_0
// and fc_1; then the pooled blocks' fc_0 and fc_1; every product dh wide.
__device__ __forceinline__ int wf_fwd_prods(const FcArgs& a) {
  return a.ns * (1 + 3 * a.n_lin_z) + 2 * (a.n_blocks - a.n_lin_z);
}
__device__ __forceinline__ WfProd wf_fwd_prod(const FcArgs& a, int p) {
  const int dh = a.d_hidden, dl = a.d_latent, per_view = 1 + 3 * a.n_lin_z;
  WfProd d{nullptr, dh, dh, 0, dh};
  const float* w0 = static_cast<const float*>(a.w0);
  const float* w1 = static_cast<const float*>(a.w1);
  if (p < a.ns * per_view) {
    const int v = p / per_view, q = p - v * per_view;
    if (q == 0) {
      d.w = static_cast<const float*>(a.wi);
      d.K = a.k_in;
    } else {
      const int k = (q - 1) / 3, s = (q - 1) % 3;
      if (s == 0) {
        d.w = static_cast<const float*>(a.wz) + (size_t)k * dl * dh;
        d.K = dl;
      } else {
        d.w = (s == 1 ? w0 : w1) + (size_t)k * dh * dh;
      }
    }
  } else {
    const int t = p - a.ns * per_view;
    d.w = ((t & 1) ? w1 : w0) + (size_t)(a.n_lin_z + t / 2) * dh * dh;
  }
  return d;
}
// Dgrad: the pooled blocks from the last down (W1, then W0), then per view
// its blocks from n_lin_z - 1 down, lin_in's windows of d_hidden columns
// (Wi's), and dz's windows of d_hidden columns, each over the injections j.
__device__ __forceinline__ void wf_dgrad_shape(const FcBwdArgs& a, int& post, int& nce, int& nzw,
                                               int& per_view) {
  const int dh = a.d_hidden;
  post = 2 * (a.n_blocks - a.n_lin_z);
  nce = (a.k_in + dh - 1) / dh;
  nzw = (a.d_latent + dh - 1) / dh;
  per_view = 2 * a.n_lin_z + nce + nzw * a.n_lin_z;
}
__device__ __forceinline__ int wf_dgrad_prods(const FcBwdArgs& a) {
  int post, nce, nzw, per_view;
  wf_dgrad_shape(a, post, nce, nzw, per_view);
  return post + a.ns * per_view;
}
__device__ __forceinline__ WfProd wf_dgrad_prod(const FcBwdArgs& a, int p) {
  const int dh = a.d_hidden, nlz = a.n_lin_z;
  int post, nce, nzw, per_view;
  wf_dgrad_shape(a, post, nce, nzw, per_view);
  WfProd d{nullptr, dh, dh, 0, dh};
  const float* w0 = static_cast<const float*>(a.w0);
  const float* w1 = static_cast<const float*>(a.w1);
  if (p < post) {
    d.w = ((p & 1) ? w0 : w1) + (size_t)(a.n_blocks - 1 - p / 2) * dh * dh;
    return d;
  }
  int e = (p - post) % per_view;
  if (e < 2 * nlz) {
    d.w = ((e & 1) ? w0 : w1) + (size_t)(nlz - 1 - e / 2) * dh * dh;
    return d;
  }
  e -= 2 * nlz;
  if (e < nce) {
    d.w = static_cast<const float*>(a.wi);
    d.ldw = a.k_in;
    d.cb = e * dh;
    d.cw = min(dh, a.k_in - d.cb);
    return d;
  }
  e -= nce;
  d.w = static_cast<const float*>(a.wz) + (size_t)(e % nlz) * dh * a.d_latent;
  d.ldw = a.d_latent;
  d.cb = e / nlz * dh;
  d.cw = min(dh, a.d_latent - d.cb);
  return d;
}

// forward: a.wi, wz, w0, w1 float32 transposed, (k_in, dh), (n_lin_z, dl,
// dh), (n_blocks, dh, dh) twice; a.pool for NS > 1, WF_TM x dh floats a CTA
// of the grid.  Four consumer warps and a producer warp.
__global__ void __launch_bounds__(WF_THREADS, 1)
resnetfc_wide_f32_fwd_kernel(const __grid_constant__ FcArgs a, int stages) {
  extern __shared__ __align__(128) unsigned char wf_shared[];
  const int dh = a.d_hidden, k_in = a.k_in, N = a.N, ns = a.ns, nb = a.n_blocks;
  const int nlz = a.n_lin_z, ldh = dh + 4, lda = wf_lda(dh, k_in);
  const WfRing r = wf_ring(wf_shared, dh, k_in, stages);
  const int tid = threadIdx.x, nc = WF_CONSUMERS;
  const int r0 = blockIdx.x * WF_TM, nv = max(0, min(WF_TM, N - r0));
  wf_start(r);
  if (tid >= nc) {
    if (tid == nc)
      wf_produce(r, [&](int p) { return wf_fwd_prod(a, p); }, wf_fwd_prods(a));
    __syncwarp();
  } else {
    float* Hs = r.Hs;
    float* As = r.As;
    uint32_t it = 0;  // the slab the consumers take next
    const WfMap m = wf_map<16>(dh);
    float acc[16][8];
    float* stash = static_cast<float*>(a.stash);
    const size_t slot = (size_t)N * dh;
    auto st = [&](int k, int j, int v) -> float* {
      return stash ? stash + stash_slot(k, j, v, ns, nlz) * slot : nullptr;
    };
    float* pool = a.pool + (size_t)blockIdx.x * WF_TM * dh;
    auto product = [&](int K) {
      wf_zero<16>(acc);
      wf_run<16>(r, it, K, dh, As, lda, m, acc);
    };
    // h = h + relu(relu(h) @ W0 + b0) @ W1 + b1: relu(h) into As (and the
    // stash), fc_0's output into As once every warp is done reading it
    auto block = [&](int k, int v) {
      named_sync(WF_BAR, nc);  // h is complete and every warp is done reading As
      wf_rows<true>(Hs, ldh, st(k, 0, v), r0, nv, dh, As, lda, nc);
      named_sync(WF_BAR, nc);
      product(dh);
      named_sync(WF_BAR, nc);
      const float* b0 = a.b0 + (size_t)k * dh;
      if (m.on) WF_OWN({
        const float4 b = __ldg(reinterpret_cast<const float4*>(b0 + col));
        f4(As, row, lda, col) = make_float4(relu(ac[0] + b.x), relu(ac[1] + b.y),
                                            relu(ac[2] + b.z), relu(ac[3] + b.w));
      })
      named_sync(WF_BAR, nc);
      if (stash) wf_rows<false>(As, lda, st(k, 1, v), r0, nv, dh, nullptr, 0, nc);
      product(dh);
      const float* b1 = a.b1 + (size_t)k * dh;
      if (m.on) WF_OWN({
        const float4 b = __ldg(reinterpret_cast<const float4*>(b1 + col));
        float4& h = f4(Hs, row, ldh, col);
        h = make_float4((h.x + ac[0]) + b.x, (h.y + ac[1]) + b.y, (h.z + ac[2]) + b.z,
                        (h.w + ac[3]) + b.w);
      })
    };

    for (int v = 0; v < ns; ++v) {
      named_sync(WF_BAR, nc);  // the previous view is done with As
      for (int idx = tid; idx < WF_TM * k_in; idx += nc) {
        const int rr = idx / k_in, j = idx - rr * k_in, row = r0 + rr;
        const int mode = a.tables[j];
        float val = 0.f;
        if (row < N && mode != 2) {
          const float p = a.x[((size_t)v * N + row) * a.d_in + a.tables[k_in + j]];
          val = mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[k_in + j]));
        }
        As[rr * lda + j] = val;
      }
      named_sync(WF_BAR, nc);
      product(k_in);
      if (m.on) WF_OWN({
        const float4 b = __ldg(reinterpret_cast<const float4*>(a.bi + col));
        f4(Hs, row, ldh, col) = make_float4(ac[0] + b.x, ac[1] + b.y, ac[2] + b.z, ac[3] + b.w);
      })
      for (int k = 0; k < nlz; ++k) {
        // the latent product over the tile's latent rows, read into As in
        // chunks of at most dh lanes
        wf_zero<16>(acc);
        const float* zg = static_cast<const float*>(a.z) + ((size_t)v * N + r0) * a.d_latent;
        for (int kc = 0; kc < a.d_latent; kc += dh) {
          const int cw = min(dh, a.d_latent - kc);
          named_sync(WF_BAR, nc);  // every warp is done reading As
          wf_rows_in(zg + kc, a.d_latent, As, lda, nv, cw, nc);
          named_sync(WF_BAR, nc);
          wf_run<16>(r, it, cw, dh, As, lda, m, acc);
        }
        const float* bz = a.bz + (size_t)k * dh;
        if (m.on) WF_OWN({
          const float4 b = __ldg(reinterpret_cast<const float4*>(bz + col));
          float4& h = f4(Hs, row, ldh, col);
          h = make_float4((h.x + ac[0]) + b.x, (h.y + ac[1]) + b.y, (h.z + ac[2]) + b.z,
                          (h.w + ac[3]) + b.w);
        })
        block(k, v);
      }
      if (ns > 1 && m.on) WF_OWN({  // each thread its own pool entries
        float4& p = f4(pool, row, dh, col);
        const float4 h = f4(Hs, row, ldh, col);
        p = v == 0 ? h : make_float4(p.x + h.x, p.y + h.y, p.z + h.z, p.w + h.w);
      })
    }
    if (ns > 1 && m.on) {
      const float inv = 1.f / (float)ns;
      WF_OWN({
        const float4 p = f4(pool, row, dh, col);
        f4(Hs, row, ldh, col) = make_float4(p.x * inv, p.y * inv, p.z * inv, p.w * inv);
      })
    }
    for (int k = nlz; k < nb; ++k) block(k, 0);

    // relu -> lin_out (one thread a (point, output), as the first version)
    named_sync(WF_BAR, nc);
    wf_rows<true>(Hs, ldh,
                  stash ? stash + (size_t)(stash_slots(ns, nb, nlz) - 1) * slot : nullptr, r0,
                  nv, dh, As, lda, nc);
    named_sync(WF_BAR, nc);
    const float* wo = static_cast<const float*>(a.wo);
    for (int idx = tid; idx < WF_TM * a.d_out; idx += nc) {
      const int rr = idx / a.d_out, o = idx - rr * a.d_out;
      if (rr >= nv) continue;
      const float* arow = As + rr * lda;
      const float* wrow = wo + (size_t)o * dh;
      float s = 0.f;
      for (int k = 0; k < dh; ++k) s = fmaf(arow[k], wrow[k], s);
      s = s + a.bo[o];
      if (a.activate) s = o < 3 ? sigmoidf_(s) : fmaxf(s, 0.f);
      a.out[(size_t)(r0 + rr) * a.d_out + o] = s;
    }
  }
  cluster_sync();  // no CTA leaves while the cluster's copies and arrivals may still reach it
}

// dgrad: a.wi, wz, w0, w1 float32 as nn.Linear keeps them, (dh, k_in),
// (n_lin_z, dh, dl), (n_blocks, dh, dh) twice; a.pool for NS > 1, WF_TM x
// dh floats a CTA of the grid.
__global__ void __launch_bounds__(WF_THREADS, 1)
resnetfc_wide_f32_dgrad_kernel(const __grid_constant__ FcBwdArgs a, int stages) {
  extern __shared__ __align__(128) unsigned char wf_shared[];
  const int dh = a.d_hidden, dl = a.d_latent, k_in = a.k_in, N = a.N, ns = a.ns;
  const int nb = a.n_blocks, nlz = a.n_lin_z, ldh = dh + 4, lda = wf_lda(dh, k_in);
  const WfRing r = wf_ring(wf_shared, dh, k_in, stages);
  const int tid = threadIdx.x, nc = WF_CONSUMERS;
  const int r0 = blockIdx.x * WF_TM, nv = max(0, min(WF_TM, N - r0));
  wf_start(r);
  if (tid >= nc) {
    if (tid == nc)
      wf_produce(r, [&](int p) { return wf_dgrad_prod(a, p); }, wf_dgrad_prods(a));
    __syncwarp();
  } else {
    float* Hs = r.Hs;  // gh; in a view's tail the d-encoding window
    float* As = r.As;
    float* gs = r.gs;  // g_epi, WF_TM x GOUT_W
    uint32_t it = 0;
    const WfMap m = wf_map<16>(dh);
    float acc[16][8];
    const float* stash = static_cast<const float*>(a.stash);
    float* cot = static_cast<float*>(a.cot);
    const size_t slot = (size_t)N * dh;
    const float* aout = stash + (size_t)(stash_slots(ns, nb, nlz) - 1) * slot;
    const float* wo = static_cast<const float*>(a.wo);

    // lin_out: g_epi = g * act'(out_pre) (0 past d_out), to gout
    for (int idx = tid; idx < WF_TM * GOUT_W; idx += nc) {
      const int rr = idx / GOUT_W, o = idx - rr * GOUT_W, row = r0 + rr;
      float gv = 0.f;
      if (row < N && o < a.d_out) {
        gv = a.g[(size_t)row * a.d_out + o];
        if (a.activate) {
          const float* arow = aout + (size_t)row * dh;
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
    named_sync(WF_BAR, nc);
    // gh = mask(relu(h_final)) * (g_epi @ Wo)
    for (int idx = tid; idx < WF_TM * dh; idx += nc) {
      const int rr = idx / dh, c = idx - rr * dh, row = r0 + rr;
      float v = 0.f;
      if (row < N) {
        float sum = 0.f;
        for (int o = 0; o < a.d_out; ++o) sum = fmaf(gs[rr * GOUT_W + o], wo[(size_t)o * dh + c], sum);
        v = aout[(size_t)row * dh + c] > 0.f ? sum : 0.f;
      }
      Hs[rr * ldh + c] = v;
    }

    auto product = [&](const float* A, int lda_) {
      wf_zero<16>(acc);
      wf_run<16>(r, it, dh, dh, A, lda_, m, acc);
    };
    // the mask of stash rows mk (the tile's, row stride dh) at (row, col .. col + 3)
    auto mask4 = [&](const float* mk, int row, int col) -> float4 {
      return row < nv ? __ldg(reinterpret_cast<const float4*>(mk + (size_t)row * dh + col))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    // block k of view v, backward: c1 = gh (its cotangent slot); c0 =
    // mask(relu(fc_0)) * (c1 @ W1) into As (its slot); gh += mask(relu(h)) *
    // (c0 @ W0)
    auto block = [&](int k, int v) {
      const float* m1 = stash + stash_slot(k, 1, v, ns, nlz) * slot + (size_t)r0 * dh;
      const float* m0 = stash + stash_slot(k, 0, v, ns, nlz) * slot + (size_t)r0 * dh;
      if (tid == 0 && nv > 0) {  // the block's two masks, read in its products' epilogues
        bulk_prefetch_l2(m1, (uint32_t)(nv * dh * 4));
        bulk_prefetch_l2(m0, (uint32_t)(nv * dh * 4));
      }
      named_sync(WF_BAR, nc);  // gh is complete and every warp is done reading As
      wf_rows<false>(Hs, ldh, cot + stash_slot(k, 1, v, ns, nlz) * slot, r0, nv, dh, nullptr, 0,
                     nc);
      product(Hs, ldh);
      if (m.on) WF_OWN({
        const float4 mk = mask4(m1, row, col);
        f4(As, row, lda, col) = make_float4(mk.x > 0.f ? ac[0] : 0.f, mk.y > 0.f ? ac[1] : 0.f,
                                            mk.z > 0.f ? ac[2] : 0.f, mk.w > 0.f ? ac[3] : 0.f);
      })
      named_sync(WF_BAR, nc);
      wf_rows<false>(As, lda, cot + stash_slot(k, 0, v, ns, nlz) * slot, r0, nv, dh, nullptr, 0,
                     nc);
      product(As, lda);
      if (m.on) WF_OWN({
        const float4 mk = mask4(m0, row, col);
        float4& h = f4(Hs, row, ldh, col);
        if (mk.x > 0.f) h.x += ac[0];
        if (mk.y > 0.f) h.y += ac[1];
        if (mk.z > 0.f) h.z += ac[2];
        if (mk.w > 0.f) h.w += ac[3];
      })
    };

    // the view's tail: cot_in, dx and enc through lin_in's backward, dz
    auto tail = [&](int v) {
      named_sync(WF_BAR, nc);
      wf_rows<false>(Hs, ldh, cot + cot_in_slot(v, ns, nb, nlz) * slot, r0, nv, dh, As, lda, nc);
      named_sync(WF_BAR, nc);
      // d encoding = cot_in @ Wi in windows of at most dh columns into Hs
      // (gh is no longer needed), each summed onto dx
      for (int cb = 0; cb < k_in; cb += dh) {
        const int cw = min(dh, k_in - cb);
        auto dwin = [&](auto ptc) {
          constexpr int PT = decltype(ptc)::value;
          constexpr int S = 16 / PT;
          const WfMap w = wf_map<PT>(cw);
          float wacc[PT][8];
          wf_zero<PT>(wacc);
          wf_run<PT>(r, it, dh, cw, As, lda, w, wacc);
          if (w.on) {
#pragma unroll
            for (int i = 0; i < PT; ++i) {
              f4(Hs, w.tp + S * i, ldh, w.c0) =
                  make_float4(wacc[i][0], wacc[i][1], wacc[i][2], wacc[i][3]);
              f4(Hs, w.tp + S * i, ldh, w.c1) =
                  make_float4(wacc[i][4], wacc[i][5], wacc[i][6], wacc[i][7]);
            }
          }
        };
        switch (wf_pt(cw)) {
          case 1: dwin(std::integral_constant<int, 1>{}); break;
          case 2: dwin(std::integral_constant<int, 2>{}); break;
          case 4: dwin(std::integral_constant<int, 4>{}); break;
          case 8: dwin(std::integral_constant<int, 8>{}); break;
          default: dwin(std::integral_constant<int, 16>{}); break;
        }
        named_sync(WF_BAR, nc);
        for (int idx = tid; idx < WF_TM * a.d_in; idx += nc) {
          const int rr = idx / a.d_in, lane = idx - rr * a.d_in, row = r0 + rr;
          if (row >= N) continue;
          const size_t at = ((size_t)v * N + row) * a.d_in + lane;
          const float p = a.x[at];
          float sum = cb == 0 ? 0.f : a.dx[at];
          for (int jj = 0; jj < cw; ++jj) {
            const int j = cb + jj, mode = a.tables[j];
            if (mode == 2 || a.tables[k_in + j] != lane) continue;
            float d = Hs[rr * ldh + jj];
            if (mode == 1)
              d = d * (cosf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[k_in + j])) * a.fph[j]);
            sum += d;
          }
          a.dx[at] = sum;
        }
        named_sync(WF_BAR, nc);  // the window is read before the next one is written
      }
      float* enc = static_cast<float*>(a.enc) + (size_t)v * N * k_in;
      for (int idx = tid; idx < WF_TM * k_in; idx += nc) {
        const int rr = idx / k_in, j = idx - rr * k_in, row = r0 + rr;
        if (row >= N) continue;
        const int mode = a.tables[j];
        float val = 0.f;
        if (mode != 2) {
          const float p = a.x[((size_t)v * N + row) * a.d_in + a.tables[k_in + j]];
          val = mode == 0 ? p : sinf(__fadd_rn(__fmul_rn(p, a.fph[j]), a.fph[k_in + j]));
        }
        enc[(size_t)row * k_in + j] = val;
      }
      // dz = sum over j of G_j @ Wz_j in windows of at most dh columns, one
      // float32 sum; G_j (cot_in, then block j - 1's c1) the rows this CTA
      // stored, read back into As
      float* dz = static_cast<float*>(a.dz) + (size_t)v * N * dl;
      for (int cb = 0; cb < dl; cb += dh) {
        const int cw = min(dh, dl - cb);
        auto zwin = [&](auto ptc) {
          constexpr int PT = decltype(ptc)::value;
          constexpr int S = 16 / PT;
          const WfMap w = wf_map<PT>(cw);
          float wacc[PT][8];
          wf_zero<PT>(wacc);
          for (int j = 0; j < nlz; ++j) {
            const int sj = j == 0 ? cot_in_slot(v, ns, nb, nlz) : stash_slot(j - 1, 1, v, ns, nlz);
            named_sync(WF_BAR, nc);  // every warp is done reading As
            wf_rows_in(cot + sj * slot + (size_t)r0 * dh, dh, As, lda, nv, dh, nc);
            named_sync(WF_BAR, nc);
            wf_run<PT>(r, it, dh, cw, As, lda, w, wacc);
          }
          if (w.on) {
#pragma unroll
            for (int i = 0; i < PT; ++i) {
              const int row = w.tp + S * i;
              if (row >= nv) continue;
              float* o = dz + (size_t)(r0 + row) * dl + cb;
              *reinterpret_cast<float4*>(o + w.c0) =
                  make_float4(wacc[i][0], wacc[i][1], wacc[i][2], wacc[i][3]);
              *reinterpret_cast<float4*>(o + w.c1) =
                  make_float4(wacc[i][4], wacc[i][5], wacc[i][6], wacc[i][7]);
            }
          }
        };
        switch (wf_pt(cw)) {
          case 1: zwin(std::integral_constant<int, 1>{}); break;
          case 2: zwin(std::integral_constant<int, 2>{}); break;
          case 4: zwin(std::integral_constant<int, 4>{}); break;
          case 8: zwin(std::integral_constant<int, 8>{}); break;
          default: zwin(std::integral_constant<int, 16>{}); break;
        }
      }
    };

    // the pooled blocks (all of them at NS 1), then per view its blocks from
    // gh = the pooled cotangent / NS
    float* pool = a.pool + (size_t)blockIdx.x * WF_TM * dh;
    for (int k = nb - 1; k >= nlz; --k) block(k, 0);
    if (ns > 1 && m.on) WF_OWN({ f4(pool, row, dh, col) = f4(Hs, row, ldh, col); })
    const float inv_ns = 1.f / (float)ns;
    for (int v = 0; v < ns; ++v) {
      if (ns > 1) {
        named_sync(WF_BAR, nc);  // the previous view's tail is done with Hs
        if (m.on) WF_OWN({
          const float4 p = f4(pool, row, dh, col);
          f4(Hs, row, ldh, col) = make_float4(p.x * inv_ns, p.y * inv_ns, p.z * inv_ns,
                                              p.w * inv_ns);
        })
      }
      for (int k = nlz - 1; k >= 0; --k) block(k, v);
      tail(v);
    }
  }
  cluster_sync();
}

#undef WF_OWN

// A cluster launch of WF_CLUSTER CTAs a cluster over every WF_TM-point tile
// (the grid rounded up to whole clusters), WF_THREADS threads a CTA;
// returns cudaLaunchKernelEx's error, or the launch's.
template <typename Args>
int wf_launch(void (*kernel)(Args, int), const Args& a, cudaStream_t s) {
  const int stages = wf_stages(a.d_hidden, a.k_in);
  const size_t smem = wf_smem(a.d_hidden, a.k_in);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (a.N + WF_TM - 1) / WF_TM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((tiles + WF_CLUSTER - 1) / WF_CLUSTER * WF_CLUSTER));
  cfg.blockDim = dim3(WF_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = WF_CLUSTER;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a, stages);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

bool wf_shape_ok(int N, int ns, int k_in, int d_latent, int d_hidden, int d_out, int n_blocks,
                 int n_lin_z) {
  return shape_ok(N, ns, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z, 0) &&
         d_hidden <= WF_DH_MAX && wf_stages(d_hidden, k_in) >= WF_STAGES_MIN;
}

}  // namespace

// The bf16 forward on the TMA cluster kernel (wi, wz, w0, w1 as nn.Linear
// keeps them), for ops/kernels/resnetfc.py forward_route's "wide_tma"
// shapes.  Returns cudaLaunchKernelEx's or the launch's cudaError_t.
extern "C" int avr_resnetfc_fwd_wide_tma(const void* x, const void* z, const void* wi,
                                         const void* bi, const void* wz, const void* bz,
                                         const void* w0, const void* b0, const void* w1,
                                         const void* b1, const void* wo, const void* bo,
                                         const void* tables, const void* fph, void* out,
                                         void* stash, void* pool, int N, int ns, int d_in,
                                         int k_in, int d_latent, int d_hidden, int d_out,
                                         int n_blocks, int n_lin_z, int activate, void* stream) {
  const uintptr_t aligned = (uintptr_t)z | (uintptr_t)wi | (uintptr_t)wz | (uintptr_t)w0 |
                            (uintptr_t)w1 | (uintptr_t)stash;
  if (!wt_shape_ok(N, ns, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z, false) ||
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
  WtMaps m;
  int e;
  if ((e = wt_map(&m.wi, wi, 1, d_hidden, k_in)) || (e = wt_map(&m.wz, wz, n_lin_z, d_hidden,
                                                                 d_latent)) ||
      (e = wt_map(&m.w0, w0, n_blocks, d_hidden, d_hidden)) ||
      (e = wt_map(&m.w1, w1, n_blocks, d_hidden, d_hidden)))
    return e;
  return wt_launch(resnetfc_wide_tma_fwd_kernel, a, m,
                   wt_smem(d_hidden, d_latent, k_in, false), (cudaStream_t)stream);
}

// The bf16 dgrad on the TMA cluster kernel (wi, wz, w0, w1 the transposed
// copies), for backward_route's "wide_tma" shapes.  Returns
// cudaLaunchKernelEx's or the launch's cudaError_t.
extern "C" int avr_resnetfc_dgrad_wide_tma(const void* x, const void* g, const void* stash,
                                           const void* wi, const void* wz, const void* w0,
                                           const void* w1, const void* wo, const void* bo,
                                           const void* tables, const void* fph, void* dx,
                                           void* dz, void* cot, void* gout, void* enc, void* pool,
                                           int N, int ns, int d_in, int k_in, int d_latent,
                                           int d_hidden, int d_out, int n_blocks, int n_lin_z,
                                           int activate, void* stream) {
  const uintptr_t aligned = (uintptr_t)stash | (uintptr_t)wi | (uintptr_t)wz | (uintptr_t)w0 |
                            (uintptr_t)w1 | (uintptr_t)cot | (uintptr_t)dz;
  if (!wt_shape_ok(N, ns, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z, true) ||
      (ns > 1 && !pool) || (aligned & 15))
    return (int)cudaErrorInvalidValue;
  FcBwdArgs a;
  a.x = (const float*)x; a.g = (const float*)g; a.stash = stash; a.wi = wi; a.wz = wz;
  a.w0 = w0; a.w1 = w1; a.wo = wo; a.bo = (const float*)bo; a.tables = (const int*)tables;
  a.fph = (const float*)fph; a.dx = (float*)dx; a.dz = dz; a.cot = cot; a.gout = gout;
  a.enc = enc; a.pool = (float*)pool; a.N = N; a.ns = ns; a.d_in = d_in; a.k_in = k_in;
  a.d_latent = d_latent; a.d_hidden = d_hidden; a.d_out = d_out; a.n_blocks = n_blocks;
  a.n_lin_z = n_lin_z; a.activate = activate;
  WtMaps m;
  int e;
  if ((e = wt_map(&m.wi, wi, 1, k_in, d_hidden)) || (e = wt_map(&m.wz, wz, n_lin_z, d_latent,
                                                                 d_hidden)) ||
      (e = wt_map(&m.w0, w0, n_blocks, d_hidden, d_hidden)) ||
      (e = wt_map(&m.w1, w1, n_blocks, d_hidden, d_hidden)))
    return e;
  return wt_launch(resnetfc_wide_tma_dgrad_kernel, a, m, wt_smem(d_hidden, d_latent, k_in, true),
                   (cudaStream_t)stream);
}

// The float32 forward on the cluster kernel (wi, wz, w0, w1 transposed), for
// ops/kernels/resnetfc.py forward_route's "wide_f32" shapes.  Returns
// cudaLaunchKernelEx's or the launch's cudaError_t.
extern "C" int avr_resnetfc_fwd_wide_f32(const void* x, const void* z, const void* wi,
                                         const void* bi, const void* wz, const void* bz,
                                         const void* w0, const void* b0, const void* w1,
                                         const void* b1, const void* wo, const void* bo,
                                         const void* tables, const void* fph, void* out,
                                         void* stash, void* pool, int N, int ns, int d_in,
                                         int k_in, int d_latent, int d_hidden, int d_out,
                                         int n_blocks, int n_lin_z, int activate, void* stream) {
  const uintptr_t aligned = (uintptr_t)z | (uintptr_t)wi | (uintptr_t)wz | (uintptr_t)w0 |
                            (uintptr_t)w1 | (uintptr_t)stash | (uintptr_t)pool | (uintptr_t)bi |
                            (uintptr_t)bz | (uintptr_t)b0 | (uintptr_t)b1;
  if (!wf_shape_ok(N, ns, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z) ||
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
  return wf_launch(resnetfc_wide_f32_fwd_kernel, a, (cudaStream_t)stream);
}

// The float32 dgrad on the cluster kernel (wi, wz, w0, w1 as nn.Linear keeps
// them), for backward_route's "wide_f32" shapes.  Returns
// cudaLaunchKernelEx's or the launch's cudaError_t.
extern "C" int avr_resnetfc_dgrad_wide_f32(const void* x, const void* g, const void* stash,
                                           const void* wi, const void* wz, const void* w0,
                                           const void* w1, const void* wo, const void* bo,
                                           const void* tables, const void* fph, void* dx,
                                           void* dz, void* cot, void* gout, void* enc, void* pool,
                                           int N, int ns, int d_in, int k_in, int d_latent,
                                           int d_hidden, int d_out, int n_blocks, int n_lin_z,
                                           int activate, void* stream) {
  const uintptr_t aligned = (uintptr_t)stash | (uintptr_t)wi | (uintptr_t)wz | (uintptr_t)w0 |
                            (uintptr_t)w1 | (uintptr_t)cot | (uintptr_t)dz | (uintptr_t)pool;
  if (!wf_shape_ok(N, ns, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z) ||
      (ns > 1 && !pool) || (aligned & 15))
    return (int)cudaErrorInvalidValue;
  FcBwdArgs a;
  a.x = (const float*)x; a.g = (const float*)g; a.stash = stash; a.wi = wi; a.wz = wz;
  a.w0 = w0; a.w1 = w1; a.wo = wo; a.bo = (const float*)bo; a.tables = (const int*)tables;
  a.fph = (const float*)fph; a.dx = (float*)dx; a.dz = dz; a.cot = cot; a.gout = gout;
  a.enc = enc; a.pool = (float*)pool; a.N = N; a.ns = ns; a.d_in = d_in; a.k_in = k_in;
  a.d_latent = d_latent; a.d_hidden = d_hidden; a.d_out = d_out; a.n_blocks = n_blocks;
  a.n_lin_z = n_lin_z; a.activate = activate;
  return wf_launch(resnetfc_wide_f32_dgrad_kernel, a, (cudaStream_t)stream);
}
