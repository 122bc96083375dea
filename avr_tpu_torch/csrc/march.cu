// K3: fused LSTM ray-march, forward and backward.
//
// Replaces avr_tpu/ops/pallas/march.py:703 fused_lstm_march: the forward
// (_fwd_kernel :205 with the cell _cell_fwd :129, called at :556) and its
// backward (_bwd_kernel :381 with step_bwd :435, called at :621).  Per ray
// and step: project into each source view (packed scalars), 4-tap bilinear
// gather mean-pooled over the views, LSTM cell (gate order i, f, g, o;
// gates = (v W_ih + h W_hh) + b in float32, matmul operands rounded to the
// compute dtype, the carries h, c and the coordinates float32), signed step
// s = round(h) . w_out + b_out along the ray, optional early-stop freeze (a
// frozen step contributes exactly zero).  The backward clips the *combined*
// hidden cotangent to +-grad_clamp and passes a NaN through.
//
// What bounds it on H100: neither peak.  At the train step's call (4 x
// 4,096 rays x 10 steps, C 512, hidden 16) the gate products are ~11 GFLOP
// (0.011 ms at the bf16 peak) and the saved rows ~79 MB (0.024 ms at the
// HBM rate); the taps come from L2 (a view's latent is 4 MB), ~0.67 GB a
// pass.  The 10 steps depend on each other, so the time is 10 times the
// latency of one step of one tile, as long as enough tiles run to fill the
// card; a latency, not a roofline.
//
// Two routes (ops/kernels/march.py march_route):
//
// bf16, the main path: ray tiles on the tensor cores.  A warp marches a
// tile of TILE_RAYS = 16 rays in lockstep and its products are
// mma.sync.m16n8k16 (bf16 operands, float32 sums) with the tile's rays as
// M.  Why mma.sync and not wgmma: wgmma takes 64 rows a warpgroup, so 4,096
// rays would make 64 warpgroups and leave half the card idle, and its
// asynchronous TMA ring pays off over K loops far longer than one step's
// 512 channels.  The warps of a CTA share one copy of the weights in shared
// memory, so an SM holds up to 8 tiles (128 rays) in flight where a
// warp-per-ray kernel held 16 rays (tile_warps picks the warps a CTA for
// the fewest waves).  The gate columns are permuted (gate_permutation;
// W_ih's and W_hh's on the host, the bias as the kernels stage it): n8
// tile 4 b + k holds gate k of units 8 b .. 8 b + 7, hidden padded to HP, a
// multiple of 16, with zero weights (a padded unit stays exactly 0).  A
// lane's accumulators then hold i, f, g and o of the same two units of two
// rays: the cell runs in registers with no shuffle, and round(h) is
// already the A fragment of the next step's h W_hh product (two n8
// accumulator tiles are one k16 A fragment).  The weights come as B
// fragments in lane order (b_fragments: one 16-byte load a lane feeds two
// n8 tiles), from shared memory while W_ih fits there (64 KB at hidden 16),
// else from L2 (hidden above 32); the wrapper keeps the forward's fragments
// per weight, so a served frame gathers them once.
//
// Forward, per tile and step: the (ray, view) taps into shared memory; the
// gather (the warp's 32 lanes over one ray's channel groups, 16-byte loads
// from L2, GATHER_ITEMS groups in flight a lane), blended and meaned in
// float32 and rounded into the warp's A tile (16 x C bf16); gates = A W_ih
// + round(h) W_hh + b by mma.sync; the cell; s summed over the 4 lanes
// that hold a ray.  Under autograd every ray and step writes its saved row
// (aux_width), a frozen one its point and active = 0, which the backward's
// bins read.  The tile leaves the loop when none of its rays is active.
//
// Backward, per tile, steps in reverse: the step head and the cell backward
// in the forward's fragment layout, from the saved rows; round(dgates) as A
// fragments; gh = dgates W_hh^T and dv = dgates W_ih^T (16 x C, DV_CHUNK
// channels a product) by mma.sync; then two lanes a ray reload the taps
// from L2, re-blend v_t from them and take the per-tap dots <dv, f_tap>
// into the coordinate cotangent (strict border mask), chained through the
// projection to coords_{t-1}.  No float atomics: each ray-step writes
// round(dv / NS) (bf16), its point, v_t with round(h_prev) after it, and
// round(dgates); the latent cotangent is then K5's binned accumulation
// (csrc/bins.cuh: one owner a (view, 8 x 8 tile), one fixed order, dfeat
// written once in bf16); dW_ih and dW_hh one bf16 wgrad of two jobs after
// this kernel (csrc/resnetfc_hopper.cu resnetfc_wgrad_wgmma_kernel; dW_hh
// as register accumulators over the walk would take 512 registers a lane
// at hidden 62, as a job it reads 32 more bytes a ray-step); the bias and
// step-head sums per lane in shared memory, per CTA in a buffer, added in
// CTA order by lstm_march_partials_kernel.  Every output is bit for bit
// the same on a rerun.
//
// float32: ray tiles on FMA (float32 operands on the tensor cores would
// round to TF32): lstm_march_f32_tile_kernel and lstm_march_f32_walk_kernel,
// below.  A warp carries 8 rays in lockstep, the CTA's warps share the
// weights, and the gate products (the walk's dv and gh) are register-tiled
// FMA chains in the order of the warp-per-ray kernels they replace, so their
// outputs are those kernels' bits.  The walk has no float atomics, as the
// tile backward: each ray-step writes dv / NS as a float32 row and its point
// (a frozen step a zero row at the point the forward saved), and K5's bins
// sum the rows into dfeat through their float32 accumulate (march_bins_f32;
// the rows are ~335 MB at the train step's 4 x 4,096 rays x 10 steps x 512
// channels, written once and read once); v_t | h_prev and the gate
// cotangents are dW_ih's and dW_hh's rows, one float32 wgrad of two jobs
// after the walk (csrc/resnetfc.cu: split partials added in split order);
// the bias and step-head sums are each lane's own over its warp's
// ray-steps, summed in warp order per CTA and added in CTA order by
// lstm_march_partials_kernel.  Every output is bit for bit the same on a
// rerun.
//
// Hidden sizes 1 .. MAX_HIDDEN = 62, the TPU kernel's 2 H + 4 <= 128.
#include "bins.cuh"
#include "hopper.cuh"

#include <climits>
#include <mutex>
#include <vector>

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_HIDDEN = 62;

// Saved row per ray and step: [h_prev (H) | c_prev (H) | cx cy cz active |
// ig fg gg og (4H) | tanh c (H) | s], padded to a multiple of 4 floats.
__host__ __device__ inline int aux_g0(int hid) { return 2 * hid + 4; }
__host__ __device__ inline int aux_width(int hid) { return (7 * hid + 5 + 3) / 4 * 4; }

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// dbias (permuted), dw_out and db_out: the CTAs' partial sums in CTA order
// (the float32 walk's, with HP = hid and the gates unpermuted, and the bf16
// tile walk's)
__global__ void __launch_bounds__(128)
lstm_march_partials_kernel(const float* __restrict__ part, int ctas, int HP,
                           float* __restrict__ dbias, float* __restrict__ dw_out,
                           float* __restrict__ db_out) {
  const int nout = 5 * HP + 1, o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= nout) return;
  float s = 0.f;
  for (int c = 0; c < ctas; ++c) s += part[(size_t)c * nout + o];
  if (o < 4 * HP) dbias[o] = s;
  else if (o < 5 * HP) dw_out[o - 4 * HP] = s;
  else *db_out = s;
}


// ---------------------------------------------------------------------------
// float32: ray tiles on FMA
// ---------------------------------------------------------------------------
//
// float32 operands stay off the tensor cores (they would round to TF32), so
// the products are FMA, register-tiled.  A warp carries a tile of F32_TILE
// rays in lockstep over the steps, and the CTA's warps share one copy of the
// weights in shared memory (W_ih, or W_ih^T for the walk, by bulk copies that
// overlap the first step while it fits in WIH_SMEM_MAX, as at C 512 and
// hidden 16; else read through L2 by 16-byte loads).  In a product a lane
// holds 4 rays x 4 columns of each 64-column block: rays rg + 2 i (rg = lane
// & 1), columns 64 b + 4 cg + j (cg = lane >> 1).  One 16-byte shared read
// of a ray's operands feeds 16 FMAs, and one of the weights 16 more (the
// other ray group's lanes read the same words); the warp-per-ray kernels
// this replaces fed one FMA a weight read.  Every output's chain still runs
// k ascending from 0.f, so the products, and with them the forward's points
// and rows and the walk's rows, are bit for bit the warp-per-ray kernels'.
// The gathers, the cells and the step head keep those kernels' arithmetic
// and lane layout: each ray's channel loads are spread over the 32 lanes as
// before (the forward's 16-byte groups, the walk's 4 channels of each
// 128-channel block a lane), the cell's lane k takes units k and k + 32
// (at hidden <= 16 two rays at a time, a half-warp each, with the same
// reduction tree), s is lane k's sum of units k and k + 32 and then the
// warp's xor tree, and the dots of the gather backward are each lane's
// chain and the same warp sum.
//
// Forward, per step: each ray's taps; h W_hh into the gate tile; v_t W_ih a
// 64-channel chunk at a time, the chunk gathered into the A tile while the
// next chunk's loads are in flight; the cell.  Walk, per step in reverse:
// the tile's saved rows (fetched a step ahead by cp.async); the cell
// backward; gh = dgates W_hh^T; dv / NS from the product's registers into
// its rows; then a ray at a time its taps and dv rows for 4 blocks of 128
// channels in flight, v_t re-blended into its row, the per-tap dots into
// the coordinate cotangent.
//
// What bounds them on H100: the FMA rate, while enough tiles are in flight.
// At 4,096 rays x 10 steps (a served chunk) the gate products are 2.7 GFLOP,
// 0.040 ms at the 67 TFLOP/s float32 peak; the walk's dv and gh products at
// the train step's 16,384 rays 11 GFLOP, 0.17 ms; the walk also rereads
// ~1.3 GB of latent taps.  The host plan (ops/kernels/march.py f32_plan)
// picks the warps a CTA so that the tiles spread over every SM in the
// fewest waves: 512 tiles at a served chunk are 128 CTAs of 4 warps, a warp
// on every scheduler.

constexpr int F32_TILE = 8;         // rays a warp carries in lockstep
constexpr int F32_BLOCK = 64;       // columns of a product's register block (16 column groups)
constexpr int F32_CHUNK = 64;       // channels of the forward's gather chunk
constexpr int F32_GATHER = 4;       // rays a lane gathers a 16-byte channel group of, a chunk
constexpr int F32_DOTS = 128;       // channels of the walk's dv block: 4 a lane
constexpr int F32_DOT_BLOCKS = 4;   // dv blocks of one ray whose taps a lane has in flight
constexpr int F32_WARPS_MAX = 8;    // warps (tiles) a CTA: up to 255 registers a lane
// W_ih (W_ih^T; bf16: their fragments) in shared memory up to this
constexpr size_t WIH_SMEM_MAX = 128 * 1024;
constexpr size_t SMEM_MAX = 232448;  // shared memory a Hopper block can use
// the forward's gather: lane l takes channel group l % 16 of a chunk (16
// groups) for rays l / 16 + 2 k, k < F32_GATHER
static_assert(F32_CHUNK == 64 && 2 * F32_GATHER == F32_TILE, "the gather's lane layout");

// a tile's row pitch in floats: k rounded up to 8, plus 4, so rows r and
// r + 1 (the two ray groups' 16-byte reads) fall in different bank groups
__host__ __device__ inline int f32_pitch(int k) { return (k + 7) / 8 * 8 + 4; }
__host__ __device__ inline int round4(int k) { return (k + 3) / 4 * 4; }
// gate columns padded to whole register blocks (zero weights)
__host__ __device__ inline int f32_gate_cols(int hid) {
  return (4 * hid + F32_BLOCK - 1) / F32_BLOCK * F32_BLOCK;
}
// the walk's W_ih^T channels padded to whole dv blocks; W_hh^T's units to 16
__host__ __device__ inline int f32_dot_cols(int C) {
  return (C + F32_DOTS - 1) / F32_DOTS * F32_DOTS;
}
__host__ __device__ inline int f32_units(int hid) { return (hid + 15) / 16 * 16; }

__host__ __device__ inline bool f32_fwd_wih_smem(int C, int hid) {
  return (size_t)C * f32_gate_cols(hid) * 4 <= WIH_SMEM_MAX;
}
__host__ __device__ inline bool f32_walk_wih_smem(int C, int hid) {
  return (size_t)4 * hid * f32_dot_cols(C) * 4 <= WIH_SMEM_MAX;
}
// the forward's CTA copy: a barrier slot, W_ih (when it fits), W_hh (rows
// padded to 4), the bias, w_out
__host__ __device__ inline size_t f32_fwd_shared(int C, int hid) {
  const size_t gp = f32_gate_cols(hid);
  return 16 + (f32_fwd_wih_smem(C, hid) ? (size_t)C * gp * 4 : 0) +
         (size_t)round4(hid) * gp * 4 + gp * 4 + 64 * 4;
}
// per warp: the A chunk (v_t), the gate tile, h, the (ray, view) taps
__host__ __device__ inline size_t f32_fwd_warp(int hid, int NS) {
  return (size_t)F32_TILE * 4 *
             (f32_pitch(F32_CHUNK) + f32_pitch(f32_gate_cols(hid)) + f32_pitch(hid)) +
         (size_t)F32_TILE * NS * sizeof(Taps);
}
// the walk's CTA copy: a barrier slot, W_ih^T (when it fits), W_hh^T, w_out
__host__ __device__ inline size_t f32_walk_shared(int C, int hid) {
  return 16 + (f32_walk_wih_smem(C, hid) ? (size_t)4 * hid * f32_dot_cols(C) * 4 : 0) +
         (size_t)4 * hid * f32_units(hid) * 4 + 64 * 4;
}
// per warp: the gate cotangents, gh, the c cotangent, two steps' saved
// rows (this step's and the next one's, in flight), the (ray, view) taps
__host__ __device__ inline size_t f32_walk_warp(int hid, int NS) {
  return (size_t)F32_TILE * 4 *
             (f32_pitch(4 * hid) + f32_pitch(f32_units(hid)) + f32_units(hid) +
              2 * aux_width(hid)) +
         (size_t)F32_TILE * NS * sizeof(Taps);
}

// acc[b][i][j] += sum over k < K, ascending (K a multiple of 4), of
// A[rg + 2 i][k] B[k][64 b + 4 cg + j]: A's rows at pitch lda in shared
// memory, B's at pitch ldb in shared memory or (GB) in global memory, where
// columns at or past ncols read as zero.  Inlined with B derived from the
// shared-memory pointer or the global one, so each loop reads its own space.
template <int NB, bool GB, int UNROLL = 2>
__device__ __forceinline__ void f32_tile_fma(const float* A, int lda, const float* B, int ldb,
                                             int K, int ncols, int rg, int cg,
                                             float (&acc)[NB][4][4]) {
  const float* ar = A + rg * lda;
  const float* br = B + 4 * cg;
#pragma unroll UNROLL
  for (int k = 0; k < K; k += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(ar + 2 * i * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float* bp = br + (size_t)(k + kk) * ldb + F32_BLOCK * b;
        float4 w;
        if (GB)
          w = F32_BLOCK * b + 4 * cg < ncols ? __ldg(reinterpret_cast<const float4*>(bp))
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
        else
          w = *reinterpret_cast<const float4*>(bp);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[b][i][j] = fmaf(x, wv[j], acc[b][i][j]);
        }
      }
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][4][4]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][i][j] = 0.f;
}

// 16 bytes global -> shared by cp.async (L2 only); commit a group; wait for
// every group but the last committed
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A CTA's copy of `bytes` contiguous bytes of weights into shared memory by
// bulk copies on the barrier `bar`, issued by thread 0 (waited on with
// mbar_wait(bar, 0) before the first read), while the CTA stages the rest
__device__ __forceinline__ void f32_bulk_stage(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar) {
  if (threadIdx.x != 0) return;
  mbar_init(bar, 1);
  mbar_fence_init();
  mbar_expect_tx(bar, bytes);
  for (uint32_t off = 0; off < bytes; off += 16384)
    bulk_load(static_cast<char*>(dst) + off, static_cast<const char*>(src) + off,
              min(16384u, bytes - off), bar);
}

// --- forward

// The forward's gather of one (chunk, view): lane (rp = lane >> 4, g = lane &
// 15) loads channel group g (channels c0 + 4 g ..) of rays rp + 2 k at their 4
// taps (maps mk[k] + view), the loads issued together; gather_blend then
// blends them in float32 and adds the view to v (view 0 starts it), each
// step rounded as the plain version's.
__device__ __forceinline__ void gather_issue(const float* feat, const Taps* taps_s,
                                             const int (&mk)[F32_GATHER], int rp, int g, int c0,
                                             int view, int gpr, int NS, int C, size_t map,
                                             float4 (&t)[F32_GATHER][4]) {
  if (g >= gpr) return;
#pragma unroll
  for (int k = 0; k < F32_GATHER; ++k) {
    const Taps& tp = taps_s[(rp + 2 * k) * NS + view];
    const float* base = feat + (size_t)(mk[k] + view) * map + c0 + 4 * g;
    t[k][0] = __ldg(reinterpret_cast<const float4*>(base + (size_t)tp.i00 * C));
    t[k][1] = __ldg(reinterpret_cast<const float4*>(base + (size_t)tp.i01 * C));
    t[k][2] = __ldg(reinterpret_cast<const float4*>(base + (size_t)tp.i10 * C));
    t[k][3] = __ldg(reinterpret_cast<const float4*>(base + (size_t)tp.i11 * C));
  }
}
__device__ __forceinline__ void gather_blend(const Taps* taps_s, int rp, int view, int NS,
                                             const float4 (&t)[F32_GATHER][4],
                                             float (&v)[F32_GATHER][4]) {
#pragma unroll
  for (int k = 0; k < F32_GATHER; ++k) {
    const Taps& tp = taps_s[(rp + 2 * k) * NS + view];
    const float f0[4] = {t[k][0].x, t[k][0].y, t[k][0].z, t[k][0].w};
    const float f1[4] = {t[k][1].x, t[k][1].y, t[k][1].z, t[k][1].w};
    const float f2[4] = {t[k][2].x, t[k][2].y, t[k][2].z, t[k][2].w};
    const float f3[4] = {t[k][3].x, t[k][3].y, t[k][3].z, t[k][3].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float val = blend4(f0[j], f1[j], f2[j], f3[j], tp);
      v[k][j] = view == 0 ? val : __fadd_rn(v[k][j], val);
    }
  }
}

struct F32FwdArgs {
  const float* proj;     // (SB, NS, 16)
  const float* coords0;  // (SB * R, 3)
  const float* rds;      // (SB * R, 3)
  const float* feat;     // (SB, NS, H, W, C)
  const float* w_ih;     // (C, 4 hid)
  const float* w_hh;     // (hid, 4 hid)
  const float* bias;     // (4 hid) [i | f | g | o]
  const float* w_out;    // (hid)
  const float* b_out;    // (1)
  float* out;            // (SB * R, 3)
  float* aux;            // (SB * R, steps, aux_width) or null
  int SB, R, NS, H, W, C, hid, steps;
  float eps;
};

// NB: 64-column blocks of the 4 hid gate columns; WSM: W_ih in shared memory
template <int NB, bool WSM>
__global__ void __launch_bounds__(F32_WARPS_MAX * 32, 1) lstm_march_f32_tile_kernel(F32FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int T = F32_TILE, GP = NB * F32_BLOCK;
  const int C = a.C, hid = a.hid, NS = a.NS, G4 = 4 * hid, HK = round4(hid);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rg = lane & 1, cg = lane >> 1;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* p = reinterpret_cast<float*>(smem + 16);
  const float* wih = a.w_ih;
  int ldw = G4;
  const bool bulk = WSM && G4 == GP;  // W_ih as it is: bulk copies, waited on before its product
  if (bulk) {
    f32_bulk_stage(p, a.w_ih, (uint32_t)C * GP * 4, bar);
  } else if (WSM) {  // W_ih with its gate columns padded to GP (zeros)
#pragma unroll 8
    for (int i = threadIdx.x; i < C * (GP / 4); i += blockDim.x) {
      const int ch = i / (GP / 4), c4 = (i - ch * (GP / 4)) * 4;
      reinterpret_cast<float4*>(p)[i] =
          c4 < G4 ? __ldg(reinterpret_cast<const float4*>(a.w_ih + (size_t)ch * G4 + c4))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (WSM) {
    wih = p;
    ldw = GP;
    p += (size_t)C * GP;
  }
  float* whh_s = p;  // W_hh, rows padded to HK and columns to GP (zeros)
  p += (size_t)HK * GP;
  float* bias_s = p;
  p += GP;
  float* wout_s = p;
  p += 64;
  for (int i = threadIdx.x; i < HK * GP; i += blockDim.x) {
    const int u = i / GP, q = i - u * GP;
    whh_s[i] = u < hid && q < G4 ? a.w_hh[u * G4 + q] : 0.f;
  }
  for (int i = threadIdx.x; i < GP; i += blockDim.x) bias_s[i] = i < G4 ? a.bias[i] : 0.f;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) wout_s[i] = i < hid ? a.w_out[i] : 0.f;
  const int AP = f32_pitch(F32_CHUNK), GTP = f32_pitch(GP), HP = f32_pitch(hid);
  p += (size_t)warp * (f32_fwd_warp(hid, NS) / 4);
  float* a_s = p;                  // T rays x AP: a chunk of v_t
  float* gt_s = a_s + T * AP;      // T x GTP: h W_hh, then the gates
  float* h_s = gt_s + T * GTP;     // T x HP: h (units past hid stay 0)
  Taps* taps_s = reinterpret_cast<Taps*>(h_s + T * HP);  // [ray][view]
  for (int i = lane; i < T * HP; i += 32) h_s[i] = 0.f;
  for (int i = lane; i < T * NS; i += 32)  // every tap a valid pixel
    taps_s[i] = bilinear_taps(0.f, 0.f, a.H, a.W);
  __syncthreads();

  const long long rays = (long long)a.SB * a.R;
  const long long tile0 = ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * T;
  if (tile0 >= rays) return;  // no block-wide barrier follows
  // lane r < T carries ray tile0 + r: its point, direction and flag
  const long long my = tile0 + (lane < T ? lane : 0);
  const bool valid = lane < T && my < rays;
  bool act = valid;
  const int sb = valid ? (int)(my / a.R) : 0;
  const int mapv = sb * NS;  // the ray's first map
  float cx = 0.f, cy = 0.f, cz = 0.f, rx = 0.f, ry = 0.f, rz = 0.f;
  if (valid) {
    cx = a.coords0[my * 3], cy = a.coords0[my * 3 + 1], cz = a.coords0[my * 3 + 2];
    rx = a.rds[my * 3], ry = a.rds[my * 3 + 1], rz = a.rds[my * 3 + 2];
  }
  float c_state[T][2];  // the cell's c: lane k's units k and k + 32 of each ray (at
                        // hidden <= 16 unit k % 16 of rays 2 m + k / 16, in [m][0])
#pragma unroll
  for (int r = 0; r < T; ++r) c_state[r][0] = c_state[r][1] = 0.f;
  const float bo = *a.b_out;
  const float inv_ns = 1.f / (float)NS;
  const int AW = aux_width(hid), G0 = aux_g0(hid);
  const size_t map = (size_t)a.H * a.W * C;

  for (int step = 0; step < a.steps; ++step) {
    const unsigned live = __ballot_sync(FULL, act);  // bit r: ray r marches this step
    if (!live) break;
    if (act) {
      if (a.aux) {
        float* row = a.aux + ((size_t)my * a.steps + step) * AW;
        row[2 * hid] = cx;
        row[2 * hid + 1] = cy;
        row[2 * hid + 2] = cz;
        row[2 * hid + 3] = 1.f;
      }
      for (int view = 0; view < NS; ++view) {
        const Projected q = project_point(a.proj + ((size_t)mapv + view) * 16, cx, cy, cz);
        taps_s[lane * NS + view] = bilinear_taps(q.gx, q.gy, a.H, a.W);
      }
    }
    __syncwarp();

    // h W_hh into the gate tile
    {
      float acc[NB][4][4];
      zero_acc<NB>(acc);
      f32_tile_fma<NB, false>(h_s, HP, whh_s, GP, HK, GP, rg, cg, acc);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(gt_s + (rg + 2 * i) * GTP + F32_BLOCK * b + 4 * cg) =
              make_float4(acc[b][i][0], acc[b][i][1], acc[b][i][2], acc[b][i][3]);
    }
    // v_t W_ih, chunk by chunk: each chunk of v_t gathered into the A tile,
    // then its part of every chain.  Lane l gathers channel group l % 16 of
    // rays l / 16 + 2 k; the loads of the next chunk's first view are in
    // flight during this chunk's product.  They go out for every ray (a
    // frozen ray's taps are an earlier step's, or pixel 0): its row of the A
    // tile is not used.
    const int g = lane & 15, rp = lane >> 4;
    int mk[F32_GATHER];
#pragma unroll
    for (int k = 0; k < F32_GATHER; ++k) mk[k] = __shfl_sync(FULL, mapv, rp + 2 * k);
    float4 t[F32_GATHER][4];
    gather_issue(a.feat, taps_s, mk, rp, g, 0, 0, min(F32_CHUNK, C) / 4, NS, C, map, t);
    float acc[NB][4][4];
    zero_acc<NB>(acc);
    if (bulk && step == 0) mbar_wait(bar, 0);
    for (int c0 = 0; c0 < C; c0 += F32_CHUNK) {
      const int gpr = min(F32_CHUNK, C - c0) / 4;
      float v[F32_GATHER][4];
      gather_blend(taps_s, rp, 0, NS, t, v);
      for (int view = 1; view < NS; ++view) {
        gather_issue(a.feat, taps_s, mk, rp, g, c0, view, gpr, NS, C, map, t);
        gather_blend(taps_s, rp, view, NS, t, v);
      }
      if (g < gpr)
#pragma unroll
        for (int k = 0; k < F32_GATHER; ++k) {
          if (NS > 1)
#pragma unroll
            for (int j = 0; j < 4; ++j) v[k][j] = __fmul_rn(v[k][j], inv_ns);
          store16(a_s + (rp + 2 * k) * AP + 4 * g, v[k]);
        }
      __syncwarp();
      if (c0 + F32_CHUNK < C)
        gather_issue(a.feat, taps_s, mk, rp, g, c0 + F32_CHUNK, 0,
                     min(F32_CHUNK, C - c0 - F32_CHUNK) / 4, NS, C, map, t);
      f32_tile_fma<NB, !WSM, NB <= 2 ? 4 : 2>(a_s, AP, wih + (size_t)c0 * ldw, ldw, 4 * gpr, G4,
                                              rg, cg, acc);
      __syncwarp();  // the A tile is rewritten by the next chunk
    }
    // gates = (v_t W_ih + h W_hh) + b
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* gq = gt_s + (rg + 2 * i) * GTP + F32_BLOCK * b + 4 * cg;
        const float4 h4 = *reinterpret_cast<const float4*>(gq);
        const float4 b4 = *reinterpret_cast<const float4*>(bias_s + F32_BLOCK * b + 4 * cg);
        *reinterpret_cast<float4*>(gq) =
            make_float4((acc[b][i][0] + h4.x) + b4.x, (acc[b][i][1] + h4.y) + b4.y,
                        (acc[b][i][2] + h4.z) + b4.z, (acc[b][i][3] + h4.w) + b4.w);
      }
    __syncwarp();

    // the cell: lane k updates units k and k + 32 (< hid) of a ray; the step
    // head reduced over the warp.  Straight-line over the tile's rays (a ray
    // that does not march computes and keeps nothing), so the rays'
    // transcendental chains overlap.
    float s_mine = 0.f;  // lane r: its ray's step
    if constexpr (NB == 1) {
      // hidden <= 16: two rays at a time, one a half-warp (lane 16 h + k:
      // unit k of ray 2 m + h).  The reduction is the one-ray tree's: there
      // lane k + 16 holds no unit and adds +0, then xor 8 .. 1 within the half.
      const int k = lane & 15, h = lane >> 4;
#pragma unroll
      for (int m = 0; m < T / 2; ++m) {
        const int r = 2 * m + h;
        const bool lv = (live >> r) & 1u;
        const float* gr = gt_s + r * GTP;
        float* hr = h_s + r * HP;
        float* row = a.aux + ((size_t)(tile0 + r) * a.steps + step) * AW;
        float part = 0.f;
        if (k < hid) {
          const float ig = sigmoidf_(gr[k]);
          const float fg = sigmoidf_(gr[hid + k]);
          const float gg = tanhf(gr[2 * hid + k]);
          const float og = sigmoidf_(gr[3 * hid + k]);
          const float c_prev = c_state[m][0];
          const float c_new = fg * c_state[m][0] + ig * gg;
          const float tc = tanhf(c_new);
          const float hn = og * tc;
          if (lv) {
            c_state[m][0] = c_new;
            if (a.aux) {
              row[k] = hr[k];
              row[hid + k] = c_prev;
              row[G0 + k] = ig;
              row[G0 + hid + k] = fg;
              row[G0 + 2 * hid + k] = gg;
              row[G0 + 3 * hid + k] = og;
              row[G0 + 4 * hid + k] = tc;
            }
            hr[k] = hn;
          }
          part = hn * wout_s[k];
        }
        part = __fadd_rn(part, 0.f);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
        const float s0 = __shfl_sync(FULL, part, 0) + bo, s1 = __shfl_sync(FULL, part, 16) + bo;
        if (lane == 2 * m) s_mine = s0;
        if (lane == 2 * m + 1) s_mine = s1;
      }
    } else {
#pragma unroll
      for (int r = 0; r < T; ++r) {
        const bool lv = (live >> r) & 1u;
        const float* gr = gt_s + r * GTP;
        float* hr = h_s + r * HP;
        float* row = a.aux + ((size_t)(tile0 + r) * a.steps + step) * AW;
        float part = 0.f;
#pragma unroll
        for (int uu = 0; uu < 2; ++uu) {
          const int u = lane + 32 * uu;
          if (u >= hid) continue;
          const float ig = sigmoidf_(gr[u]);
          const float fg = sigmoidf_(gr[hid + u]);
          const float gg = tanhf(gr[2 * hid + u]);
          const float og = sigmoidf_(gr[3 * hid + u]);
          const float c_prev = c_state[r][uu];
          const float c_new = fg * c_state[r][uu] + ig * gg;
          const float tc = tanhf(c_new);
          const float hn = og * tc;
          if (lv) {
            c_state[r][uu] = c_new;
            if (a.aux) {
              row[u] = hr[u];
              row[hid + u] = c_prev;
              row[G0 + u] = ig;
              row[G0 + hid + u] = fg;
              row[G0 + 2 * hid + u] = gg;
              row[G0 + 3 * hid + u] = og;
              row[G0 + 4 * hid + u] = tc;
            }
            hr[u] = hn;
          }
          part = uu == 0 ? hn * wout_s[u] : part + hn * wout_s[u];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
        // one value for the whole warp (xor sums may differ in the last bit)
        const float s = __shfl_sync(FULL, part, 0) + bo;
        if (lane == r) s_mine = s;
      }
    }
    if (act) {
      cx = __fadd_rn(cx, __fmul_rn(rx, s_mine));
      cy = __fadd_rn(cy, __fmul_rn(ry, s_mine));
      cz = __fadd_rn(cz, __fmul_rn(rz, s_mine));
      if (a.aux) a.aux[((size_t)my * a.steps + step) * AW + G0 + 5 * hid] = s_mine;
      if (a.eps > 0.f && fabsf(s_mine) < a.eps) {  // frozen: s is 0 from now on
        act = false;
        if (a.aux)  // the frozen rows: their point (the bins' taps) and active = 0
          for (int t = step + 1; t < a.steps; ++t) {
            float* fr = a.aux + ((size_t)my * a.steps + t) * AW + 2 * hid;
            fr[0] = cx;
            fr[1] = cy;
            fr[2] = cz;
            fr[3] = 0.f;
          }
      }
    }
    __syncwarp();  // the taps, the A and gate tiles and h are rewritten by the next step
  }
  if (valid) {
    a.out[my * 3] = cx;
    a.out[my * 3 + 1] = cy;
    a.out[my * 3 + 2] = cz;
  }
}

template <int NB>
static int launch_f32_fwd(const F32FwdArgs& a, int warps, int ctas, size_t smem, cudaStream_t s) {
  const bool wsm = f32_fwd_wih_smem(a.C, a.hid);
  auto kernel = wsm ? lstm_march_f32_tile_kernel<NB, true> : lstm_march_f32_tile_kernel<NB, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)ctas, warps * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// `warps` a CTA and `ctas`: ops/kernels/march.py f32_plan("forward", ...)
extern "C" int avr_lstm_march_f32(const void* proj, const void* coords0, const void* rds,
                                  const void* feat, const void* w_ih, const void* w_hh,
                                  const void* bias, const void* w_out, const void* b_out,
                                  void* out, void* aux, int SB, int R, int NS, int H, int W,
                                  int C, int hid, int steps, float eps, int warps, int ctas,
                                  void* stream) {
  const size_t smem = f32_fwd_shared(C, hid) + (size_t)warps * f32_fwd_warp(hid, NS);
  if (hid < 1 || hid > MAX_HIDDEN || C % 4 || NS < 1 || warps < 1 || warps > F32_WARPS_MAX ||
      (long long)ctas * warps * F32_TILE < (long long)SB * R || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  F32FwdArgs a;
  a.proj = (const float*)proj; a.coords0 = (const float*)coords0; a.rds = (const float*)rds;
  a.feat = (const float*)feat; a.w_ih = (const float*)w_ih; a.w_hh = (const float*)w_hh;
  a.bias = (const float*)bias; a.w_out = (const float*)w_out; a.b_out = (const float*)b_out;
  a.out = (float*)out; a.aux = (float*)aux;
  a.SB = SB; a.R = R; a.NS = NS; a.H = H; a.W = W; a.C = C; a.hid = hid; a.steps = steps;
  a.eps = eps;
  cudaStream_t s = (cudaStream_t)stream;
  switch (f32_gate_cols(hid) / F32_BLOCK) {
    case 1: return launch_f32_fwd<1>(a, warps, ctas, smem, s);
    case 2: return launch_f32_fwd<2>(a, warps, ctas, smem, s);
    case 3: return launch_f32_fwd<3>(a, warps, ctas, smem, s);
    default: return launch_f32_fwd<4>(a, warps, ctas, smem, s);
  }
}

// --- backward walk

// The coordinate cotangent of a ray-step's view from its per-tap dots
// (tap_coord_grad, then project_point_bwd), each product and sum rounded
// as the warp-per-ray walk's build rounded it, so the walk keeps its bits
// (the compiler is otherwise free to fuse a different product of each sum)
__device__ __forceinline__ float3 walk_coord_grad(const float (&d)[4], const Taps& t,
                                                  const Projected& q, const float* p, int H,
                                                  int W) {
  const float d_wx = __fmaf_rn(__fsub_rn(d[1], d[0]), __fsub_rn(1.f, t.wy),
                               __fmul_rn(__fsub_rn(d[3], d[2]), t.wy));
  const float d_wy = __fmaf_rn(__fsub_rn(d[2], d[0]), __fsub_rn(1.f, t.wx),
                               __fmul_rn(__fsub_rn(d[3], d[1]), t.wx));
  const float gx = __fmul_rn(__fmul_rn(d_wx, live(q.gx, W)), 0.5f * (float)(W - 1));
  const float gy = __fmul_rn(__fmul_rn(d_wy, live(q.gy, H)), 0.5f * (float)(H - 1));
  const float inv_z = 1.f / q.camz;
  const float ax = __fmul_rn(gx, p[12]), ay = __fmul_rn(gy, p[13]);
  const float dcamx = -__fmul_rn(ax, inv_z), dcamy = -__fmul_rn(ay, inv_z);
  const float dcamz =
      __fmul_rn(__fmul_rn(__fmaf_rn(ax, q.camx, __fmul_rn(ay, q.camy)), inv_z), inv_z);
  return make_float3(__fmaf_rn(p[6], dcamz, __fmaf_rn(p[0], dcamx, __fmul_rn(p[3], dcamy))),
                     __fmaf_rn(p[7], dcamz, __fmaf_rn(p[1], dcamx, __fmul_rn(p[4], dcamy))),
                     __fmaf_rn(p[8], dcamz, __fmaf_rn(p[2], dcamx, __fmul_rn(p[5], dcamy))));
}

struct F32WalkArgs {
  const float* proj;     // (SB, NS, 16)
  const float* rds;      // (SB * R, 3)
  const float* feat;     // (SB, NS, H, W, C)
  const float* w_ihT;    // (4H, C): W_ih transposed, the dv operand
  const float* w_hh;     // (H, 4H)
  const float* w_out;    // (H)
  const float* aux;      // (SB * R, steps, AUXW)
  const float* gout;     // (SB * R, 3) cotangent of the final points
  float* dcoords0;       // (SB * R, 3)
  float* drds;           // (SB * R, 3)
  float* vbuf;           // (SB * R * steps, vld): v_t | h_prev, dW_ih's and dW_hh's rows
  float* dgbuf;          // (SB * R * steps, dg_ld): the gate cotangents
  float* dvbuf;          // (SB * R * steps, C): dv / NS, the bins' cotangent rows
  float* pts;            // (SB * R * steps, 3): the ray-step's point
  float* part;           // (CTAs, 5 H + 1): dbias | dw_out | db_out of each CTA
  int SB, R, NS, H, W, C, hid, steps, vld, dg_ld;
  float clamp;
};

// lane-owned partial sums a warp, [slot][lane]: dbias of gate k and unit
// lane + 32 uu at slot 2 k + uu, dw_out of unit lane + 32 uu at 8 + uu,
// db_out at 10 (lane 0); at hidden <= 16 lane 16 + k holds unit k's sums
// over the odd rays of the tiles, lane k over the even ones
constexpr int F32_OWN_SLOTS = 11;

// The cell backward of ray r's unit u (this lane's slot uu of the partial
// sums) from the step's saved row, in the walk kernel: the clip on the
// combined hidden cotangent, the gate cotangents into dg_s (0 where the
// ray-step is not live), the c cotangent carried in gc_s.
#define WALK_CELL(r, u, uu)                                                              \
  {                                                                                      \
    const float* row = rows_s + (r) * AW;                                                \
    const float ig = row[G0 + (u)], fg = row[G0 + hid + (u)];                            \
    const float gg = row[G0 + 2 * hid + (u)], og = row[G0 + 3 * hid + (u)];              \
    const float tc = row[G0 + 4 * hid + (u)], c_prev = row[hid + (u)];                   \
    /* the clip acts on the combined hidden cotangent (step head + next step); a NaN   \
       passes through it, as through jnp.clip and torch.clamp (fminf and fmaxf alone    \
       would turn it into -clamp) */                                                    \
    const float gsum = gh_s[(r) * GHP + (u)] + dsr * wout_s[u];                          \
    const float ghc = isnan(gsum) ? gsum : fminf(fmaxf(gsum, -a.clamp), a.clamp);        \
    const float gct = gc_s[(r) * UP + (u)] + ghc * og * (1.f - tc * tc);                 \
    const float d4[4] = {gct * gg * ig * (1.f - ig), gct * c_prev * fg * (1.f - fg),     \
                         gct * ig * (1.f - gg * gg), ghc * tc * og * (1.f - og)};        \
    if (lv) {                                                                            \
      dwo_own[uu] += og * tc * dsr;                                                      \
      gc_s[(r) * UP + (u)] = gct * fg;                                                   \
      _Pragma("unroll") for (int q = 0; q < 4; ++q) db_own[uu][q] += d4[q];              \
    }                                                                                    \
    _Pragma("unroll") for (int q = 0; q < 4; ++q)                                        \
        dg_s[(r) * DGP + q * hid + (u)] = lv ? d4[q] : 0.f;                               \
  }

// NU: W_hh^T's units in 16-unit groups; WSM: W_ih^T in shared memory
template <int NU, bool WSM>
__global__ void __launch_bounds__(F32_WARPS_MAX * 32, 1) lstm_march_f32_walk_kernel(F32WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int T = F32_TILE, UP = 16 * NU;
  const int C = a.C, hid = a.hid, NS = a.NS, G4 = 4 * hid, CP = f32_dot_cols(C);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane & 1, cg = lane >> 1;       // the dv product's rays and channel groups
  const int hr_ = lane & 7, hu = lane >> 3;      // the gh product's ray and unit group
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* p = reinterpret_cast<float*>(smem + 16);
  const float* wihT = a.w_ihT;
  int ldw = C;
  const bool bulk = WSM && C == CP;  // W_ih^T as it is: bulk copies, waited on before dv
  if (bulk) {
    f32_bulk_stage(p, a.w_ihT, (uint32_t)G4 * CP * 4, bar);
  } else if (WSM) {  // W_ih^T with its channels padded to CP (zeros)
#pragma unroll 8
    for (int i = threadIdx.x; i < G4 * (CP / 4); i += blockDim.x) {
      const int q = i / (CP / 4), c4 = (i - q * (CP / 4)) * 4;
      reinterpret_cast<float4*>(p)[i] =
          c4 < C ? __ldg(reinterpret_cast<const float4*>(a.w_ihT + (size_t)q * C + c4))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (WSM) {
    wihT = p;
    ldw = CP;
    p += (size_t)G4 * CP;
  }
  float* whhT_s = p;  // W_hh^T [q][u], units padded to UP (zeros)
  p += (size_t)G4 * UP;
  float* wout_s = p;
  p += 64;
  for (int i = threadIdx.x; i < G4 * UP; i += blockDim.x) {
    const int q = i / UP, u = i - q * UP;
    whhT_s[i] = u < hid ? a.w_hh[u * G4 + q] : 0.f;
  }
  for (int i = threadIdx.x; i < 64; i += blockDim.x) wout_s[i] = i < hid ? a.w_out[i] : 0.f;
  const int DGP = f32_pitch(G4), GHP = f32_pitch(UP);
  float* const warp0 = p;
  const size_t wfloats = f32_walk_warp(hid, NS) / 4;
  p += warp * wfloats;
  float* dg_s = p;                 // T rays x DGP: the gate cotangents
  float* gh_s = dg_s + T * DGP;    // T x GHP: the h cotangent from the step after
  float* gc_s = gh_s + T * GHP;    // T x UP: the c cotangent
  float* rows2_s = gc_s + T * UP;  // 2 x T x AW: the saved rows of steps t and t - 1
  Taps* taps_s = reinterpret_cast<Taps*>(rows2_s + 2 * T * aux_width(hid));  // [ray][view]
  for (int i = lane; i < T * GHP; i += 32) gh_s[i] = 0.f;
  for (int i = lane; i < T * UP; i += 32) gc_s[i] = 0.f;
  __syncthreads();

  const long long rays = (long long)a.SB * a.R;
  const long long tile0 = ((long long)blockIdx.x * warps + warp) * T;
  // this lane's partial sums over its warp's ray-steps, in walk order
  float db_own[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float dwo_own[2] = {0.f, 0.f}, dbo_own = 0.f;
  if (tile0 < rays) {  // warps past the last tile only join the barrier below
    // lane r < T carries ray tile0 + r: its cotangents and direction
    const long long my = tile0 + (lane < T ? lane : 0);
    const bool valid = lane < T && my < rays;
    const unsigned vmask = __ballot_sync(FULL, valid);
    const int mapv = valid ? (int)(my / a.R) * NS : 0;
    float gcx = 0.f, gcy = 0.f, gcz = 0.f, rx = 0.f, ry = 0.f, rz = 0.f;
    if (valid) {
      gcx = a.gout[my * 3], gcy = a.gout[my * 3 + 1], gcz = a.gout[my * 3 + 2];
      rx = a.rds[my * 3], ry = a.rds[my * 3 + 1], rz = a.rds[my * 3 + 2];
    }
    float grx = 0.f, gry = 0.f, grz = 0.f;
    const int AW = aux_width(hid), G0 = aux_g0(hid);
    const float inv_ns = 1.f / (float)NS;
    const size_t map = (size_t)a.H * a.W * C;

    // the tile's saved rows of a step into a shared buffer by cp.async, a
    // step ahead of their use (a ray past the last reads the tile's first)
    auto fetch_rows = [&](int step) {
      float* dst = rows2_s + (step & 1) * T * AW;
      for (int i = lane; i < T * (AW / 4); i += 32) {
        const int r = i / (AW / 4);
        const long long rr = (vmask >> r) & 1u ? tile0 + r : tile0;
        cp_async16(dst + 4 * i,
                   a.aux + ((size_t)rr * a.steps + step) * AW + 4 * (i - r * (AW / 4)));
      }
      cp_async_commit();
    };
    fetch_rows(a.steps - 1);
    for (int t = a.steps - 1; t >= 0; --t) {
      if (t > 0) fetch_rows(t - 1);
      else cp_async_commit();  // an empty group: the wait below covers step t's
      cp_async_wait_prior();
      __syncwarp();
      const float* rows_s = rows2_s + (t & 1) * T * AW;
      // lane r: its ray-step's point, flag and step; the step head's cotangent
      const size_t rsp = (size_t)my * a.steps + t;  // the ray-step's row
      float cx = 0.f, cy = 0.f, cz = 0.f, ds = 0.f;
      bool act = false;
      if (valid) {
        const float* row = rows_s + lane * AW;
        cx = row[2 * hid], cy = row[2 * hid + 1], cz = row[2 * hid + 2];
        act = row[2 * hid + 3] != 0.f;
        a.pts[rsp * 3] = cx;
        a.pts[rsp * 3 + 1] = cy;
        a.pts[rsp * 3 + 2] = cz;
        if (act) {
          const float s = row[G0 + 5 * hid];
          // coords_{t+1} = coords_t + rds * s (ds rounded as the warp-per-ray
          // walk's build rounded it)
          ds = __fmaf_rn(gcz, rz, __fmaf_rn(gcy, ry, __fmul_rn(gcx, rx)));
          grx += gcx * s;
          gry += gcy * s;
          grz += gcz * s;
          for (int view = 0; view < NS; ++view) {
            const Projected q = project_point(a.proj + ((size_t)mapv + view) * 16, cx, cy, cz);
            taps_s[lane * NS + view] = bilinear_taps(q.gx, q.gy, a.H, a.W);
          }
        }
      }
      const unsigned live = __ballot_sync(FULL, act);  // bit r: ray r's step is active

      // the cell backward: lane k takes units k and k + 32 of a ray (at
      // hidden <= 16 two rays at a time, one a half-warp: lane 16 h + k
      // takes unit k of ray 2 m + h).  A ray-step that is frozen or past the
      // last ray keeps nothing and its gate cotangents are 0.
      if constexpr (NU == 1) {
        const int k = lane & 15, h = lane >> 4;
#pragma unroll 1
        for (int m = 0; m < T / 2; ++m) {
          const int r = 2 * m + h;
          const bool lv = (live >> r) & 1u;
          const float dsr = __shfl_sync(FULL, ds, r);
          const float ds0 = __shfl_sync(FULL, ds, 2 * m), ds1 = __shfl_sync(FULL, ds, 2 * m + 1);
          if (lane == 0) {  // the rays in order
            if ((live >> (2 * m)) & 1u) dbo_own += ds0;
            if ((live >> (2 * m + 1)) & 1u) dbo_own += ds1;
          }
          if (k < hid) WALK_CELL(r, k, 0)
        }
      } else {
#pragma unroll 1
        for (int r = 0; r < T; ++r) {
          const bool lv = (live >> r) & 1u;
          const float dsr = __shfl_sync(FULL, ds, r);
          if (lane == 0 && lv) dbo_own += dsr;
#pragma unroll
          for (int uu = 0; uu < 2; ++uu) {
            const int u = lane + 32 * uu;
            if (u < hid) WALK_CELL(r, u, uu)
          }
        }
      }
      // h_prev after v_t (dW_hh's operand); a frozen step's rows all zero, at
      // the point the forward saved
#pragma unroll
      for (int r = 0; r < T; ++r) {
        if (!((vmask >> r) & 1u)) continue;
        const size_t rs = (size_t)(tile0 + r) * a.steps + t;
        if ((live >> r) & 1u) {
          for (int u = lane; u < hid; u += 32) a.vbuf[rs * a.vld + C + u] = rows_s[r * AW + u];
        } else {
          const float zero[4] = {0.f, 0.f, 0.f, 0.f};
          for (int ch = lane * 4; ch < a.vld; ch += 32 * 4) store16(a.vbuf + rs * a.vld + ch, zero);
          for (int ch = lane * 4; ch < C; ch += 32 * 4) store16(a.dvbuf + rs * C + ch, zero);
          for (int q = lane; q < G4; q += 32) a.dgbuf[rs * a.dg_ld + q] = 0.f;
        }
      }
      __syncwarp();
      // the gate cotangents: dW_ih's and dW_hh's other operand (a GEMM after
      // this kernel)
#pragma unroll
      for (int r = 0; r < T; ++r)
        if ((live >> r) & 1u) {
          float* dg_row = a.dgbuf + ((size_t)(tile0 + r) * a.steps + t) * a.dg_ld;
          for (int q = lane; q < G4; q += 32) dg_row[q] = dg_s[r * DGP + q];
        }
      // gh = dgates W_hh^T, the h cotangent of step t - 1: lane (ray lane & 7,
      // units 4 (lane >> 3) + 16 n + j), q ascending from 0.f
      {
        float acc[NU][4];
#pragma unroll
        for (int n = 0; n < NU; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        const float* dgr = dg_s + hr_ * DGP;
        for (int q = 0; q < G4; q += 4) {
          const float4 d4 = *reinterpret_cast<const float4*>(dgr + q);
          const float dq[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int n = 0; n < NU; ++n) {
              const float4 w = *reinterpret_cast<const float4*>(whhT_s + (size_t)(q + kk) * UP +
                                                                16 * n + 4 * hu);
              acc[n][0] = fmaf(dq[kk], w.x, acc[n][0]);
              acc[n][1] = fmaf(dq[kk], w.y, acc[n][1]);
              acc[n][2] = fmaf(dq[kk], w.z, acc[n][2]);
              acc[n][3] = fmaf(dq[kk], w.w, acc[n][3]);
            }
        }
        __syncwarp();  // every lane has read this step's gh (the cell above)
#pragma unroll
        for (int n = 0; n < NU; ++n)
          *reinterpret_cast<float4*>(gh_s + hr_ * GHP + 16 * n + 4 * hu) =
              make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
      }

      // dv = dgates W_ih^T / NS, F32_DOTS channels at a time, into the
      // ray-steps' dv rows (the bins' cotangent) from the product's registers
      if (bulk && t == a.steps - 1) mbar_wait(bar, 0);
      for (int c0 = 0; c0 < C; c0 += F32_DOTS) {
        float acc[2][4][4];
        zero_acc<2>(acc);
        f32_tile_fma<2, !WSM>(dg_s, DGP, wihT + c0, ldw, G4, C - c0, rg, cg, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg + 2 * i;
          if (!((live >> r) & 1u)) continue;
          float* dv_row = a.dvbuf + ((size_t)(tile0 + r) * a.steps + t) * C + c0 + 4 * cg;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            if (c0 + F32_BLOCK * b + 4 * cg >= C) continue;
            float x[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) x[j] = NS > 1 ? acc[b][i][j] * inv_ns : acc[b][i][j];
            __stcg(reinterpret_cast<float4*>(dv_row + F32_BLOCK * b),
                   make_float4(x[0], x[1], x[2], x[3]));
          }
        }
      }
      __syncwarp();  // the dv rows are read back by other lanes below
      // the gather backward per view, a ray at a time: its taps reloaded by
      // its 32 lanes (lane l: channels 4 l + F32_DOTS m, the loads of
      // F32_DOT_BLOCKS blocks in flight together with the ray's dv there),
      // v_t re-blended, the per-tap dots chained over the lane's channels
      // and summed over the warp into the ray's coordinate cotangent
      for (int view = 0; view < NS; ++view) {
#pragma unroll 1
        for (int r = 0; r < T; ++r) {
          if (!((live >> r) & 1u)) continue;
          const Taps tp = taps_s[r * NS + view];
          const size_t rs = (size_t)(tile0 + r) * a.steps + t;
          const int mr = __shfl_sync(FULL, mapv, r);
          const float* base = a.feat + (size_t)(mr + view) * map + 4 * lane;
          float dot[4] = {0.f, 0.f, 0.f, 0.f};
          for (int c0 = 0; c0 < C; c0 += F32_DOTS * F32_DOT_BLOCKS) {
            float4 tv[F32_DOT_BLOCKS][4], dv4[F32_DOT_BLOCKS];
#pragma unroll
            for (int m = 0; m < F32_DOT_BLOCKS; ++m) {
              const int ch = c0 + F32_DOTS * m + 4 * lane;
              if (ch >= C) continue;
              const float* bm = base + c0 + F32_DOTS * m;
              tv[m][0] = __ldg(reinterpret_cast<const float4*>(bm + (size_t)tp.i00 * C));
              tv[m][1] = __ldg(reinterpret_cast<const float4*>(bm + (size_t)tp.i01 * C));
              tv[m][2] = __ldg(reinterpret_cast<const float4*>(bm + (size_t)tp.i10 * C));
              tv[m][3] = __ldg(reinterpret_cast<const float4*>(bm + (size_t)tp.i11 * C));
              dv4[m] = __ldcg(reinterpret_cast<const float4*>(a.dvbuf + rs * C + ch));
            }
#pragma unroll
            for (int m = 0; m < F32_DOT_BLOCKS; ++m) {
              const int ch = c0 + F32_DOTS * m + 4 * lane;
              if (ch >= C) continue;
              float* v_row = a.vbuf + rs * a.vld + ch;
              float vo[4], val[4];
              if (view > 0) {  // v_t's view sum so far, this lane's own
                const float4 o = __ldcg(reinterpret_cast<const float4*>(v_row));
                vo[0] = o.x, vo[1] = o.y, vo[2] = o.z, vo[3] = o.w;
              }
              const float dvv[4] = {dv4[m].x, dv4[m].y, dv4[m].z, dv4[m].w};
              const float f[4][4] = {{tv[m][0].x, tv[m][0].y, tv[m][0].z, tv[m][0].w},
                                     {tv[m][1].x, tv[m][1].y, tv[m][1].z, tv[m][1].w},
                                     {tv[m][2].x, tv[m][2].y, tv[m][2].z, tv[m][2].w},
                                     {tv[m][3].x, tv[m][3].y, tv[m][3].z, tv[m][3].w}};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                val[j] = blend4(f[0][j], f[1][j], f[2][j], f[3][j], tp);
                if (view > 0) val[j] = __fadd_rn(vo[j], val[j]);
                if (NS > 1 && view == NS - 1) val[j] = __fmul_rn(val[j], inv_ns);
#pragma unroll
                for (int k = 0; k < 4; ++k) dot[k] = fmaf(dvv[j], f[k][j], dot[k]);
              }
              // v_t as the forward computed it (dW_ih's operand); with NS > 1
              // the views' sum so far until the last view
              __stcs(reinterpret_cast<float4*>(v_row), make_float4(val[0], val[1], val[2], val[3]));
            }
          }
          float d[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) d[k] = __shfl_sync(FULL, warp_sum(dot[k]), 0);
          const float px = __shfl_sync(FULL, cx, r), py = __shfl_sync(FULL, cy, r);
          const float pz = __shfl_sync(FULL, cz, r);
          // every lane alike (no divergence), lane r keeps it
          const float* pj = a.proj + ((size_t)mr + view) * 16;
          const float3 dw = walk_coord_grad(d, tp, project_point(pj, px, py, pz), pj, a.H, a.W);
          if (lane == r) {
            gcx += dw.x;
            gcy += dw.y;
            gcz += dw.z;
          }
        }
      }
      __syncwarp();  // the taps, dg_s and gh_s are rewritten by the next step
    }
    if (valid) {
      a.dcoords0[my * 3] = gcx;
      a.dcoords0[my * 3 + 1] = gcy;
      a.dcoords0[my * 3 + 2] = gcz;
      a.drds[my * 3] = grx;
      a.drds[my * 3 + 1] = gry;
      a.drds[my * 3 + 2] = grz;
    }
  }
  // the CTA's partial sums: each output's owning lane, warps in order (the
  // slots over the warp's gh, c cotangent and rows)
  __syncwarp();
  float* own_w = warp0 + warp * wfloats + T * f32_pitch(4 * hid);
#pragma unroll
  for (int uu = 0; uu < 2; ++uu) {
#pragma unroll
    for (int k = 0; k < 4; ++k) own_w[(2 * k + uu) * 32 + lane] = db_own[uu][k];
    own_w[(8 + uu) * 32 + lane] = dwo_own[uu];
  }
  own_w[10 * 32 + lane] = dbo_own;
  __syncthreads();
  const int nout = 5 * hid + 1;
  for (int o = threadIdx.x; o < nout; o += blockDim.x) {
    int slot, l;
    if (o < G4) {  // dbias: gate o / hid of unit o % hid
      const int u = o % hid;
      slot = 2 * (o / hid) + u / 32, l = u % 32;
    } else if (o < 5 * hid) {
      const int u = o - G4;
      slot = 8 + u / 32, l = u % 32;
    } else {
      slot = 10, l = 0;
    }
    float sum = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float* ow = warp0 + w * wfloats + T * f32_pitch(4 * hid) + slot * 32;
      sum += ow[l];
      if (NU == 1 && o < 5 * hid) sum += ow[l + 16];  // the odd rays' half-warp
    }
    a.part[(size_t)blockIdx.x * nout + o] = sum;
  }
}

template <int NU>
static int launch_f32_walk(const F32WalkArgs& a, int warps, int ctas, size_t smem,
                           cudaStream_t s) {
  const bool wsm = f32_walk_wih_smem(a.C, a.hid);
  auto kernel = wsm ? lstm_march_f32_walk_kernel<NU, true> : lstm_march_f32_walk_kernel<NU, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)ctas, warps * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The float32 backward: the walk, the latent cotangent through the bins'
// float32 accumulate, the partial sums' reduction.  dW_ih and dW_hh follow
// as the wrapper's float32 wgrad over vbuf and dgbuf.  No float atomics.
// `warps` a CTA and `ctas`: ops/kernels/march.py f32_plan("walk", ...), fixed
// by the shapes and the SM count; `part` holds `ctas` rows.
extern "C" int avr_lstm_march_bwd_f32(const void* proj, const void* rds, const void* feat,
                                      const void* w_ihT, const void* w_hh, const void* w_out,
                                      const void* aux, const void* gout, void* dcoords0,
                                      void* drds, void* vbuf, void* dgbuf, void* dvbuf, void* pts,
                                      void* part, void* dfeat, void* ints, void* partials,
                                      void* dbias, void* dw_out, void* db_out, int SB, int R,
                                      int NS, int H, int W, int C, int hid, int steps, int vld,
                                      int dg_ld, int warps, int ctas, float clamp, void* stream) {
  const size_t smem = f32_walk_shared(C, hid) + (size_t)warps * f32_walk_warp(hid, NS);
  if (hid < 1 || hid > MAX_HIDDEN || dg_ld < 4 * hid || vld < C + hid || vld % 4 || C % 4 ||
      NS < 1 || warps < 1 || warps > F32_WARPS_MAX ||
      (long long)ctas * warps * F32_TILE < (long long)SB * R || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  F32WalkArgs a;
  a.proj = (const float*)proj; a.rds = (const float*)rds; a.feat = (const float*)feat;
  a.w_ihT = (const float*)w_ihT; a.w_hh = (const float*)w_hh; a.w_out = (const float*)w_out;
  a.aux = (const float*)aux; a.gout = (const float*)gout; a.dcoords0 = (float*)dcoords0;
  a.drds = (float*)drds; a.vbuf = (float*)vbuf; a.dgbuf = (float*)dgbuf;
  a.dvbuf = (float*)dvbuf; a.pts = (float*)pts; a.part = (float*)part;
  a.SB = SB; a.R = R; a.NS = NS; a.H = H; a.W = W; a.C = C; a.hid = hid; a.steps = steps;
  a.vld = vld; a.dg_ld = dg_ld; a.clamp = clamp;
  cudaStream_t s = (cudaStream_t)stream;
  int e;
  switch (f32_units(hid) / 16) {
    case 1: e = launch_f32_walk<1>(a, warps, ctas, smem, s); break;
    case 2: e = launch_f32_walk<2>(a, warps, ctas, smem, s); break;
    case 3: e = launch_f32_walk<3>(a, warps, ctas, smem, s); break;
    default: e = launch_f32_walk<4>(a, warps, ctas, smem, s); break;
  }
  if (e) return e;
  march_bins_f32((const float*)pts, (const float*)proj, (const float*)dvbuf, (float*)dfeat, ints,
                 partials, SB * NS, NS, H, W, C, R * steps, s);
  lstm_march_partials_kernel<<<(5 * hid + 1 + 127) / 128, 128, 0, s>>>(
      (const float*)part, ctas, hid, (float*)dbias, (float*)dw_out, (float*)db_out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: ray tiles on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TILE_RAYS = 16;       // rays a warp marches in lockstep: the products' M
constexpr int UNIT_BLOCK = 8;       // units of one n8 tile of the permuted gates
constexpr int TILE_WARPS_MAX = 8;   // warps (tiles) a CTA
constexpr int GATHER_ITEMS = 4;     // 16-byte channel groups a lane has in flight
constexpr int DV_CHUNK = 64;        // channels of one dv product

// hidden padded to a multiple of 16 (two n8 tiles of units: one k16 chunk)
__host__ __device__ inline int padded_hidden(int hid) { return (hid + 15) / 16 * 16; }
// channels padded to the products' k16 (zero weights and A columns)
__host__ __device__ inline int padded_channels(int C) { return (C + 15) / 16 * 16; }
// The gate column of [i | f | g | o] (4 hid wide) at permuted column p, or
// -1 for the zero padding: n8 tile 4 b + k holds gate k of units
// UNIT_BLOCK b .. (ops/kernels/march.py gate_permutation)
__device__ inline int gate_source(int p, int hid) {
  const int k = p / UNIT_BLOCK % 4, u = p / (4 * UNIT_BLOCK) * UNIT_BLOCK + p % UNIT_BLOCK;
  return u < hid ? k * hid + u : -1;
}
// the forward's A tile pitch in bf16: 16-byte rows an odd number of 16-byte
// units apart, so ldmatrix's eight rows hit eight bank groups
__host__ __device__ inline int a_pitch(int C) { return padded_channels(C) + 8; }
// the backward's dv tile pitch in bf16: row pitch = 2 mod 8 16-byte units, so
// the eight lanes of a quarter warp (four rays, two lanes each) hit eight
// bank groups when they read their ray's channels
__host__ __device__ inline int dv_pitch(int C) {
  const int d = C / 8;
  return 8 * (d + ((2 - d) % 8 + 8) % 8);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf16_lo(w[i]);
    f[2 * i + 1] = bf16_hi(w[i]);
  }
}
__device__ __forceinline__ void load_taps(const bf16* base, const Taps& tp, int C, uint4* t) {
  t[0] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)tp.i00 * C));
  t[1] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)tp.i01 * C));
  t[2] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)tp.i10 * C));
  t[3] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)tp.i11 * C));
}

// Warps a CTA for `tiles` tiles of `kernel`: the fewest waves on the card,
// then the most warps a CTA (fewer copies of the weights) that keep at least
// half the SMs busy; 0 if none fits.  Plans are kept per (kernel, device,
// shape), so a repeated call costs no occupancy queries.
struct TilePlan {
  const void* kernel;
  int dev;
  long long tiles;
  size_t shared, per_warp, smem;
  int warps;
};
template <typename K>
static int tile_warps(K kernel, long long tiles, size_t shared, size_t per_warp, int* warps,
                      size_t* smem) {
  static std::mutex lock;
  static std::vector<TilePlan> plans;
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  {
    std::lock_guard<std::mutex> g(lock);
    for (const TilePlan& q : plans)
      if (q.kernel == (const void*)kernel && q.dev == dev && q.tiles == tiles &&
          q.shared == shared && q.per_warp == per_warp) {
        *warps = q.warps;
        *smem = q.smem;
        return 0;
      }
  }
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)SMEM_MAX)) != cudaSuccess)
    return (int)e;
  long long best = LLONG_MAX;
  bool best_spread = false;
  *warps = 0;
  for (int w = TILE_WARPS_MAX; w >= 1; w >>= 1) {
    const size_t sm = shared + (size_t)w * per_warp;
    if (sm > SMEM_MAX) continue;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, w * 32, sm)) !=
        cudaSuccess)
      return (int)e;
    if (per_sm < 1) continue;
    const long long slots = (long long)sms * per_sm, ctas = (tiles + w - 1) / w;
    const long long waves = (ctas + slots - 1) / slots;
    const bool spread = 2 * ctas >= sms;
    if (waves < best || (waves == best && spread && !best_spread)) {
      best = waves;
      best_spread = spread;
      *warps = w;
      *smem = sm;
    }
  }
  if (*warps) {
    std::lock_guard<std::mutex> g(lock);
    plans.push_back({(const void*)kernel, dev, tiles, shared, per_warp, *smem, *warps});
  }
  return 0;
}

// --- forward

struct TileFwdArgs {
  const float* proj;     // (SB, NS, 16)
  const float* coords0;  // (SB * R, 3)
  const float* rds;      // (SB * R, 3)
  const bf16* feat;      // (SB, NS, H, W, C)
  const uint4* wih;      // W_ih, permuted gates, as B fragments (Cp / 16, HP / 4, 32)
  const uint4* whh;      // W_hh, permuted gates, as B fragments (HP / 16, HP / 4, 32)
  const float* bias;     // (4 hid) [i | f | g | o], permuted as it is staged
  const float* w_out;    // (hid) rounded to bf16, zero padded as it is staged
  const float* b_out;    // (1)
  float* out;            // (SB * R, 3)
  float* aux;            // (SB * R, steps, aux_width) or null
  int SB, R, NS, H, W, C, hid, steps;
  float eps;
  int wih_smem;          // W_ih's fragments copied to shared memory
};

__host__ __device__ inline size_t tile_fwd_shared(int C, int HP, bool wih_smem) {
  return (wih_smem ? (size_t)padded_channels(C) * 4 * HP * 2 : 0) + (size_t)HP * 4 * HP * 2 +
         (4 * HP + HP) * sizeof(float);
}
// per warp: the A tile, the (ray, view) taps, the rays' points and flags,
// each ray's first map (its scene's view 0)
__host__ __device__ inline size_t tile_fwd_warp(int C, int NS) {
  return (size_t)TILE_RAYS * a_pitch(C) * 2 + (size_t)TILE_RAYS * NS * sizeof(Taps) +
         TILE_RAYS * sizeof(float4) + TILE_RAYS * sizeof(int);
}

// NG: hidden padded to 16 NG units
template <int NG>
__global__ void __launch_bounds__(TILE_WARPS_MAX * 32) lstm_march_tile_kernel(TileFwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int HP = 16 * NG, NTP = HP / 4;  // n8 tile pairs of the 4 HP gate columns
  const int C = a.C, KC = padded_channels(C) / 16, NS = a.NS, hid = a.hid, AP = a_pitch(C);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;  // accumulator rows g, g + 8; columns 2 q, 2 q + 1
  unsigned char* p = smem;
  const uint4* wih = a.wih;
  if (a.wih_smem) {
    for (int i = threadIdx.x; i < KC * NTP * 32; i += blockDim.x)
      reinterpret_cast<uint4*>(p)[i] = __ldg(a.wih + i);
    wih = reinterpret_cast<const uint4*>(p);
    p += (size_t)KC * NTP * 32 * 16;
  }
  uint4* whh_s = reinterpret_cast<uint4*>(p);
  p += (size_t)NG * NTP * 32 * 16;
  float* bias_s = reinterpret_cast<float*>(p);
  float* wout_s = bias_s + 4 * HP;
  p += (4 * HP + HP) * sizeof(float);
  for (int i = threadIdx.x; i < NG * NTP * 32; i += blockDim.x) whh_s[i] = __ldg(a.whh + i);
  for (int i = threadIdx.x; i < 4 * HP; i += blockDim.x) {
    const int src = gate_source(i, hid);
    bias_s[i] = src < 0 ? 0.f : a.bias[src];
  }
  for (int i = threadIdx.x; i < HP; i += blockDim.x) wout_s[i] = i < hid ? a.w_out[i] : 0.f;
  p += (size_t)warp * tile_fwd_warp(C, NS);
  bf16* a_s = reinterpret_cast<bf16*>(p);  // 16 rays x AP: v_t rounded
  Taps* taps_s = reinterpret_cast<Taps*>(p + (size_t)TILE_RAYS * AP * 2);  // [ray][view]
  float4* ray_s = reinterpret_cast<float4*>(taps_s + TILE_RAYS * NS);      // point, active
  int* map_s = reinterpret_cast<int*>(ray_s + TILE_RAYS);  // ray's first map: scene x NS
  for (int i = lane; i < TILE_RAYS * AP / 8; i += 32)  // columns past C stay zero
    reinterpret_cast<uint4*>(a_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = lane; i < TILE_RAYS * NS; i += 32)  // every tap a valid pixel
    taps_s[i] = bilinear_taps(0.f, 0.f, a.H, a.W);

  const long long rays = (long long)a.SB * a.R;
  const long long tile0 = ((long long)blockIdx.x * warps + warp) * TILE_RAYS;
  const size_t map = (size_t)a.H * a.W * C;
  if (lane < TILE_RAYS) {
    const long long r = tile0 + lane < rays ? tile0 + lane : 0;
    map_s[lane] = (int)(r / a.R) * NS;
  }
  __syncthreads();
  if (tile0 >= rays) return;  // no block-wide barrier follows
  // this lane's rays: rows g and g + 8 of the tile (the quad's four lanes hold the same)
  long long ray[2];
  bool valid[2], act[2];
  float cx[2], cy[2], cz[2], rx[2], ry[2], rz[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ray[i] = tile0 + g + 8 * i;
    valid[i] = act[i] = ray[i] < rays;
    const long long r = valid[i] ? ray[i] : tile0;
    cx[i] = a.coords0[r * 3], cy[i] = a.coords0[r * 3 + 1], cz[i] = a.coords0[r * 3 + 2];
    rx[i] = a.rds[r * 3], ry[i] = a.rds[r * 3 + 1], rz[i] = a.rds[r * 3 + 2];
  }
  float cst[NG][2][4];  // c: [16-unit group][unit block][row, unit parity]
  uint32_t hf[NG][4];   // round(h) as the A fragment of the h W_hh product's k16 chunk
#pragma unroll
  for (int G = 0; G < NG; ++G)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hf[G][j] = 0u;
      cst[G][j >> 1][0] = cst[G][j >> 1][1] = cst[G][j >> 1][2] = cst[G][j >> 1][3] = 0.f;
    }
  const float bo = *a.b_out;
  const float inv_ns = 1.f / (float)NS;
  const int AW = aux_width(hid), G0 = aux_g0(hid), groups = C / 8, items = TILE_RAYS * groups;

  for (int step = 0; step < a.steps; ++step) {
    if (!__any_sync(FULL, act[0] || act[1])) {  // every ray of the tile froze
      if (a.aux && q == 0)
        for (int t = step; t < a.steps; ++t)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (valid[i]) {
              float* row = a.aux + ((size_t)ray[i] * a.steps + t) * AW + 2 * hid;
              row[0] = cx[i], row[1] = cy[i], row[2] = cz[i], row[3] = 0.f;
            }
      break;
    }
    if (q == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ray_s[g + 8 * i] = make_float4(cx[i], cy[i], cz[i], act[i] ? 1.f : 0.f);
        if (a.aux && valid[i]) {  // the row's point and flag (a frozen ray's whole row)
          float* row = a.aux + ((size_t)ray[i] * a.steps + step) * AW + 2 * hid;
          row[0] = cx[i], row[1] = cy[i], row[2] = cz[i], row[3] = act[i] ? 1.f : 0.f;
        }
      }
    __syncwarp();
    for (int i = lane; i < TILE_RAYS * NS; i += 32) {  // taps of every active (ray, view)
      const int r = i / NS, view = i - r * NS;
      const float4 c = ray_s[r];
      if (c.w == 0.f) continue;
      const Projected pq = project_point(a.proj + (size_t)(map_s[r] + view) * 16, c.x, c.y, c.z);
      taps_s[i] = bilinear_taps(pq.gx, pq.gy, a.H, a.W);
    }
    __syncwarp();
    // the gather: item i is channel group i % groups of ray i / groups; the
    // loads go out unconditionally (a frozen ray's taps are an earlier
    // step's, or pixel 0), only the stores are masked
    for (int i0 = 0; i0 < items; i0 += 32 * GATHER_ITEMS) {
      float v[GATHER_ITEMS][8];
      int rk[GATHER_ITEMS];
      const bf16* bk[GATHER_ITEMS];
#pragma unroll
      for (int k = 0; k < GATHER_ITEMS; ++k) {
        const int i = min(i0 + 32 * k + lane, items - 1);
        rk[k] = i / groups;
        bk[k] = a.feat + map_s[rk[k]] * map + (size_t)(i - rk[k] * groups) * 8;
      }
      for (int view = 0; view < NS; ++view) {
        uint4 t[GATHER_ITEMS][4];
#pragma unroll
        for (int k = 0; k < GATHER_ITEMS; ++k)
          load_taps(bk[k] + view * map, taps_s[rk[k] * NS + view], C, t[k]);
#pragma unroll
        for (int k = 0; k < GATHER_ITEMS; ++k) {
          const Taps& tp = taps_s[rk[k] * NS + view];
          float f0[8], f1[8], f2[8], f3[8];
          unpack8(t[k][0], f0);
          unpack8(t[k][1], f1);
          unpack8(t[k][2], f2);
          unpack8(t[k][3], f3);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float val = blend4(f0[j], f1[j], f2[j], f3[j], tp);
            v[k][j] = view == 0 ? val : __fadd_rn(v[k][j], val);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < GATHER_ITEMS; ++k) {
        const int i = i0 + 32 * k + lane;
        if (i >= items || ray_s[rk[k]].w == 0.f) continue;
        if (NS > 1)
#pragma unroll
          for (int j = 0; j < 8; ++j) v[k][j] = __fmul_rn(v[k][j], inv_ns);
        store16(a_s + rk[k] * AP + (i - rk[k] * groups) * 8, v[k]);  // rounded to bf16
      }
    }
    __syncwarp();

    // gates and cell, 16 units (8 n8 tiles of gates) at a time
    float part[2] = {0.f, 0.f};  // the step head's sum of the lane's units, rows g, g + 8
    uint32_t hn[NG][4];
#pragma unroll
    for (int G = 0; G < NG; ++G) {
      float acc[8][4], hac[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = hac[j][e] = 0.f;
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t af[4];
        ldsm_x4(af, a_s + (lane & 15) * AP + kc * 16 + (lane >> 4) * 8, false);
        const uint4* wb = wih + ((size_t)kc * NTP + 4 * G) * 32 + lane;
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const uint4 b = wb[pp * 32];
          mma_m16n8k16(acc[2 * pp], af, b.x, b.y);
          mma_m16n8k16(acc[2 * pp + 1], af, b.z, b.w);
        }
      }
#pragma unroll
      for (int kc = 0; kc < NG; ++kc) {
        const uint4* wb = whh_s + ((size_t)kc * NTP + 4 * G) * 32 + lane;
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const uint4 b = wb[pp * 32];
          mma_m16n8k16(hac[2 * pp], hf[kc], b.x, b.y);
          mma_m16n8k16(hac[2 * pp + 1], hf[kc], b.z, b.w);
        }
      }
      // tile 4 ub + k of the group: gate k of unit block 2 G + ub
#pragma unroll
      for (int ub = 0; ub < 2; ++ub) {
        const int blk = 2 * G + ub;
        float hv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // row g + 8 (e >> 1), unit parity e & 1
          const int row = e >> 1, u = blk * UNIT_BLOCK + 2 * q + (e & 1);
          const int col = 4 * blk * UNIT_BLOCK + 2 * q + (e & 1);  // gate 0's permuted column
          float pre[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            pre[k] = (acc[4 * ub + k][e] + hac[4 * ub + k][e]) + bias_s[col + k * UNIT_BLOCK];
          const float ig = sigmoidf_(pre[0]), fg = sigmoidf_(pre[1]);
          const float gg = tanhf(pre[2]), og = sigmoidf_(pre[3]);
          const float c_prev = cst[G][ub][e];
          cst[G][ub][e] = fg * c_prev + ig * gg;
          const float tc = tanhf(cst[G][ub][e]);
          hv[e] = round_to<bf16>(og * tc);
          if (a.aux && act[row] && u < hid) {
            float* r = a.aux + ((size_t)ray[row] * a.steps + step) * AW;
            const uint32_t hp = hf[G][2 * ub + row];
            r[u] = (e & 1) ? bf16_hi(hp) : bf16_lo(hp);
            r[hid + u] = c_prev;
            r[G0 + u] = ig;
            r[G0 + hid + u] = fg;
            r[G0 + 2 * hid + u] = gg;
            r[G0 + 3 * hid + u] = og;
            r[G0 + 4 * hid + u] = tc;
          }
          part[row] += hv[e] * wout_s[u];
        }
        hn[G][2 * ub] = pack_bf16x2(hv[0], hv[1]);
        hn[G][2 * ub + 1] = pack_bf16x2(hv[2], hv[3]);
      }
    }
#pragma unroll
    for (int G = 0; G < NG; ++G)
#pragma unroll
      for (int j = 0; j < 4; ++j) hf[G][j] = hn[G][j];
    // s: the quad's sum (the same in its four lanes: float addition commutes)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      part[i] += __shfl_xor_sync(FULL, part[i], 1);
      part[i] += __shfl_xor_sync(FULL, part[i], 2);
      if (!act[i]) continue;
      const float s = part[i] + bo;
      if (a.aux && q == 0) a.aux[((size_t)ray[i] * a.steps + step) * AW + G0 + 5 * hid] = s;
      cx[i] = __fadd_rn(cx[i], __fmul_rn(rx[i], s));
      cy[i] = __fadd_rn(cy[i], __fmul_rn(ry[i], s));
      cz[i] = __fadd_rn(cz[i], __fmul_rn(rz[i], s));
      if (a.eps > 0.f && fabsf(s) < a.eps) act[i] = false;  // frozen: s is 0 from now on
    }
    __syncwarp();  // ray_s, taps_s and a_s are rewritten by the next step
  }
  if (q == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (valid[i]) {
        a.out[ray[i] * 3] = cx[i];
        a.out[ray[i] * 3 + 1] = cy[i];
        a.out[ray[i] * 3 + 2] = cz[i];
      }
}

template <int NG> static int launch_tile_fwd(TileFwdArgs a, cudaStream_t s) {
  const int HP = 16 * NG;
  const long long tiles = ((long long)a.SB * a.R + TILE_RAYS - 1) / TILE_RAYS;
  int warps = 0, e;
  size_t smem = 0;
  // W_ih's fragments in shared memory where they fit beside one warp, else from L2
  for (int wsm = 1; wsm >= 0 && !warps; --wsm) {
    a.wih_smem = wsm && (size_t)padded_channels(a.C) * 4 * HP * 2 <= WIH_SMEM_MAX;
    if (wsm && !a.wih_smem) continue;
    if ((e = tile_warps(lstm_march_tile_kernel<NG>, tiles, tile_fwd_shared(a.C, HP, a.wih_smem),
                        tile_fwd_warp(a.C, a.NS), &warps, &smem)))
      return e;
  }
  if (!warps) return (int)cudaErrorInvalidValue;
  lstm_march_tile_kernel<NG><<<(unsigned)((tiles + warps - 1) / warps), warps * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int avr_lstm_march_tiles(const void* proj, const void* coords0, const void* rds,
                                    const void* feat, const void* wih, const void* whh,
                                    const void* bias, const void* w_out, const void* b_out,
                                    void* out, void* aux, int SB, int R, int NS, int H, int W,
                                    int C, int hid, int steps, float eps, void* stream) {
  if (hid < 1 || hid > MAX_HIDDEN || C % 8) return (int)cudaErrorInvalidValue;
  TileFwdArgs a;
  a.proj = (const float*)proj; a.coords0 = (const float*)coords0; a.rds = (const float*)rds;
  a.feat = (const bf16*)feat; a.wih = (const uint4*)wih; a.whh = (const uint4*)whh;
  a.bias = (const float*)bias; a.w_out = (const float*)w_out; a.b_out = (const float*)b_out;
  a.out = (float*)out; a.aux = (float*)aux;
  a.SB = SB; a.R = R; a.NS = NS; a.H = H; a.W = W; a.C = C; a.hid = hid; a.steps = steps;
  a.eps = eps; a.wih_smem = 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (padded_hidden(hid) / 16) {
    case 1: return launch_tile_fwd<1>(a, s);
    case 2: return launch_tile_fwd<2>(a, s);
    case 3: return launch_tile_fwd<3>(a, s);
    default: return launch_tile_fwd<4>(a, s);
  }
}

// --- backward

struct TileBwdArgs {
  const float* proj;     // (SB, NS, 16)
  const float* rds;      // (SB * R, 3)
  const bf16* feat;      // (SB, NS, H, W, C)
  const uint4* wihT;     // W_ih^T (K: permuted gates) as B fragments (HP / 4, Cp / 16, 32)
  const uint4* whhT;     // W_hh^T (K: permuted gates) as B fragments (HP / 4, HP / 16, 32)
  const float* w_out;    // (hid) rounded to bf16, zero padded as it is staged
  const float* aux;      // (SB * R, steps, aux_width): the forward's rows
  const float* gout;     // (SB * R, 3) cotangent of the final points
  float* dcoords0;       // (SB * R, 3)
  float* drds;           // (SB * R, 3)
  bf16* vbuf;            // (SB * R * steps, C + HP): v_t | round(h_prev)
  bf16* dgbuf;           // (SB * R * steps, 4 HP): round(dgates), permuted
  bf16* dvbuf;           // (SB * R * steps, C): round(dv / NS)
  float* pts;            // (SB * R * steps, 3): the ray-step's point
  float* part;           // (CTAs, 5 HP + 1): dbias (permuted) | dw_out | db_out of each CTA
  int SB, R, NS, H, W, C, hid, steps;
  float clamp;
  int wih_smem;          // W_ih^T's fragments copied to shared memory
};

__host__ __device__ inline size_t tile_bwd_shared(int C, int HP, bool wih_smem) {
  return (wih_smem ? (size_t)4 * HP * padded_channels(C) * 2 : 0) + (size_t)4 * HP * HP * 2 +
         align16(HP * sizeof(float));
}
// lane-owned partial sums a warp: [slot][lane], HP dbias slots, HP / 4 dw_out, 1 db_out
__host__ __device__ inline int own_slots(int HP) { return HP + HP / 4 + 1; }
// per warp: the dv tile, v_t's float32 view sums (NS > 1), the rays' ds and
// flags, then the lane-owned partial sums
__host__ __device__ inline size_t own_offset(int C, int NS) {
  return (size_t)TILE_RAYS * dv_pitch(C) * 2 + (NS > 1 ? (size_t)TILE_RAYS * C * 4 : 0) +
         TILE_RAYS * sizeof(float2);
}
__host__ __device__ inline size_t tile_bwd_warp(int C, int NS, int HP) {
  return own_offset(C, NS) + (size_t)own_slots(HP) * 32 * 4;
}

template <int NG>
__global__ void __launch_bounds__(TILE_WARPS_MAX * 32) lstm_march_tile_bwd_kernel(TileBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int HP = 16 * NG, KK = HP / 4;  // k16 chunks of the 4 HP gates
  const int C = a.C, NS = a.NS, hid = a.hid, NPC = padded_channels(C) / 16, DP = dv_pitch(C);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;   // fragment layout: rows g, g + 8; units 2 q, 2 q + 1
  const int pr = lane >> 1, ph = lane & 1; // ray layout: ray pr, channel groups ph, ph + 2, ...
  unsigned char* p = smem;
  const uint4* wihT = a.wihT;
  if (a.wih_smem) {
    for (int i = threadIdx.x; i < KK * NPC * 32; i += blockDim.x)
      reinterpret_cast<uint4*>(p)[i] = __ldg(a.wihT + i);
    wihT = reinterpret_cast<const uint4*>(p);
    p += (size_t)KK * NPC * 32 * 16;
  }
  uint4* whhT_s = reinterpret_cast<uint4*>(p);
  p += (size_t)KK * NG * 32 * 16;
  float* wout_s = reinterpret_cast<float*>(p);
  p += align16(HP * sizeof(float));
  for (int i = threadIdx.x; i < KK * NG * 32; i += blockDim.x) whhT_s[i] = __ldg(a.whhT + i);
  for (int i = threadIdx.x; i < HP; i += blockDim.x) wout_s[i] = i < hid ? a.w_out[i] : 0.f;
  unsigned char* const warp0 = p;
  const size_t wbytes = tile_bwd_warp(C, NS, HP);
  p += (size_t)warp * wbytes;
  bf16* dv_s = reinterpret_cast<bf16*>(p);  // 16 rays x DP: round(dv / NS)
  float* vacc = reinterpret_cast<float*>(p + (size_t)TILE_RAYS * DP * 2);  // 16 x C (NS > 1)
  float2* ray_s = reinterpret_cast<float2*>(p + own_offset(C, NS) - TILE_RAYS * sizeof(float2));
  float* own = reinterpret_cast<float*>(p + own_offset(C, NS));
  const int OWN_DW = HP, OWN_DB = HP + HP / 4;  // first dw_out slot, the db_out slot
  for (int i = lane; i < own_slots(HP) * 32; i += 32) own[i] = 0.f;
  __syncthreads();

  const long long rays = (long long)a.SB * a.R;
  const long long tile0 = ((long long)blockIdx.x * warps + warp) * TILE_RAYS;
  if (tile0 < rays) {  // warps past the last tile only join the barrier below
    const int AW = aux_width(hid), G0 = aux_g0(hid), VW = C + HP;
    const float inv_ns = 1.f / (float)NS;
    const int groups = C / 8, mine = (groups - ph + 1) / 2;  // this lane's channel groups
    const unsigned pair = 3u << (lane & ~1);
    // ray layout: ray pr
    const long long rp = tile0 + pr;
    const bool vp = rp < rays;
    const long long rpc = vp ? rp : tile0;
    const int sbp = (int)(rpc / a.R);
    const float rdx = a.rds[rpc * 3], rdy = a.rds[rpc * 3 + 1], rdz = a.rds[rpc * 3 + 2];
    float gcx = vp ? a.gout[rpc * 3] : 0.f, gcy = vp ? a.gout[rpc * 3 + 1] : 0.f;
    float gcz = vp ? a.gout[rpc * 3 + 2] : 0.f;
    float grx = 0.f, gry = 0.f, grz = 0.f;
    // fragment layout: rays g, g + 8
    long long rf[2];
    bool vf[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rf[i] = tile0 + g + 8 * i;
      vf[i] = rf[i] < rays;
      if (!vf[i]) rf[i] = tile0;
    }
    float gh[NG][2][4], gcell[NG][2][4];  // h and c cotangents: [group][unit block][row, parity]
#pragma unroll
    for (int G = 0; G < NG; ++G)
#pragma unroll
      for (int ub = 0; ub < 2; ++ub)
#pragma unroll
        for (int e = 0; e < 4; ++e) gh[G][ub][e] = gcell[G][ub][e] = 0.f;

    for (int t = a.steps - 1; t >= 0; --t) {
      // the step head, a ray per lane pair
      const size_t rsp = (size_t)rpc * a.steps + t;  // the ray-step's row
      const float* rowp = a.aux + rsp * AW;
      const bool actp = vp && __ldg(rowp + 2 * hid + 3) != 0.f;
      const float cx = __ldg(rowp + 2 * hid), cy = __ldg(rowp + 2 * hid + 1);
      const float cz = __ldg(rowp + 2 * hid + 2);
      float ds = 0.f;
      if (actp) {  // coords_{t+1} = coords_t + rds * s
        const float s = __ldg(rowp + G0 + 5 * hid);
        ds = gcx * rdx + gcy * rdy + gcz * rdz;
        grx += gcx * s;
        gry += gcy * s;
        grz += gcz * s;
      }
      if (ph == 0) {
        ray_s[pr] = make_float2(ds, actp ? 1.f : 0.f);
        own[OWN_DB * 32 + lane] += ds;
        if (vp) {
          a.pts[rsp * 3] = cx;
          a.pts[rsp * 3 + 1] = cy;
          a.pts[rsp * 3 + 2] = cz;
        }
      }
      __syncwarp();

      // the cell backward in the forward's fragment layout
      float dsf[2];
      bool af[2];
      const float* rowf[2];
      size_t rsf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 r = ray_s[g + 8 * i];
        dsf[i] = r.x;
        af[i] = r.y != 0.f;
        rsf[i] = (size_t)rf[i] * a.steps + t;
        rowf[i] = a.aux + rsf[i] * AW;
      }
      uint32_t dgf[4 * NG][4];  // round(dgates): A fragments of the gate contraction
#pragma unroll
      for (int G = 0; G < NG; ++G)
#pragma unroll
        for (int ub = 0; ub < 2; ++ub) {
          const int blk = 2 * G + ub;
          float dgv[4][4], hpv[4];  // [gate][row, parity]; round(h_prev) [row, parity]
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e >> 1, u = blk * UNIT_BLOCK + 2 * q + (e & 1);
            float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f, tc = 0.f, c_prev = 0.f, hp = 0.f;
            if (af[row] && u < hid) {  // frozen rays, padded units: exactly zero
              const float* r = rowf[row];
              ig = __ldg(r + G0 + u), fg = __ldg(r + G0 + hid + u);
              gg = __ldg(r + G0 + 2 * hid + u), og = __ldg(r + G0 + 3 * hid + u);
              tc = __ldg(r + G0 + 4 * hid + u), c_prev = __ldg(r + hid + u), hp = __ldg(r + u);
            }
            hpv[e] = hp;
            const float dsr = dsf[row];
            own[(OWN_DW + 2 * blk + (e & 1)) * 32 + lane] +=
                round_to<bf16>(og * tc) * round_to<bf16>(dsr);
            // the clip acts on the combined hidden cotangent (step head + next
            // step); a NaN passes through it, as through jnp.clip and torch.clamp
            const float gsum = gh[G][ub][e] + dsr * wout_s[u];
            const float ghc = isnan(gsum) ? gsum : fminf(fmaxf(gsum, -a.clamp), a.clamp);
            const float gct = gcell[G][ub][e] + ghc * og * (1.f - tc * tc);
            dgv[0][e] = gct * gg * ig * (1.f - ig);
            dgv[1][e] = gct * c_prev * fg * (1.f - fg);
            dgv[2][e] = gct * ig * (1.f - gg * gg);
            dgv[3][e] = ghc * tc * og * (1.f - og);
            gcell[G][ub][e] = gct * fg;
#pragma unroll
            for (int k = 0; k < 4; ++k) own[((4 * blk + k) * 2 + (e & 1)) * 32 + lane] += dgv[k][e];
          }
          // tile 4 blk + k is half k & 1 of the k16 chunk 2 blk + k / 2
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t lo = pack_bf16x2(dgv[k][0], dgv[k][1]);
            const uint32_t hi = pack_bf16x2(dgv[k][2], dgv[k][3]);
            dgf[2 * blk + (k >> 1)][2 * (k & 1)] = lo;
            dgf[2 * blk + (k >> 1)][2 * (k & 1) + 1] = hi;
            const int col = (4 * blk + k) * UNIT_BLOCK + 2 * q;
            if (vf[0]) *reinterpret_cast<uint32_t*>(a.dgbuf + rsf[0] * (4 * HP) + col) = lo;
            if (vf[1]) *reinterpret_cast<uint32_t*>(a.dgbuf + rsf[1] * (4 * HP) + col) = hi;
          }
          // round(h_prev) after v_t: dW_hh's operand
          const int u0 = blk * UNIT_BLOCK + 2 * q;
          if (vf[0])
            *reinterpret_cast<uint32_t*>(a.vbuf + rsf[0] * VW + C + u0) =
                pack_bf16x2(hpv[0], hpv[1]);
          if (vf[1])
            *reinterpret_cast<uint32_t*>(a.vbuf + rsf[1] * VW + C + u0) =
                pack_bf16x2(hpv[2], hpv[3]);
        }
      // gh = round(dgates) W_hh^T: the h cotangent of step t - 1, in the same layout
#pragma unroll
      for (int G = 0; G < NG; ++G) {
        float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const uint4 b = whhT_s[((size_t)kk * NG + G) * 32 + lane];
          mma_m16n8k16(d0, dgf[kk], b.x, b.y);
          mma_m16n8k16(d1, dgf[kk], b.z, b.w);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gh[G][0][e] = d0[e];
          gh[G][1][e] = d1[e];
        }
      }
      // dv = round(dgates) W_ih^T, rounded after / NS, into the warp's dv tile
      for (int n0 = 0; n0 < NPC; n0 += DV_CHUNK / 16) {
        float acc[DV_CHUNK / 8][4];
#pragma unroll
        for (int j = 0; j < DV_CHUNK / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const uint4* wb = wihT + ((size_t)kk * NPC + n0) * 32 + lane;
#pragma unroll
          for (int pp = 0; pp < DV_CHUNK / 16; ++pp) {
            if (n0 + pp >= NPC) break;
            const uint4 b = wb[pp * 32];
            mma_m16n8k16(acc[2 * pp], dgf[kk], b.x, b.y);
            mma_m16n8k16(acc[2 * pp + 1], dgf[kk], b.z, b.w);
          }
        }
#pragma unroll
        for (int j = 0; j < DV_CHUNK / 8; ++j) {
          const int col = n0 * 16 + j * 8 + 2 * q;
          if (col >= C) break;
#pragma unroll
          for (int row = 0; row < 2; ++row) {
            float x0 = acc[j][2 * row], x1 = acc[j][2 * row + 1];
            if (NS > 1) x0 *= inv_ns, x1 *= inv_ns;
            *reinterpret_cast<uint32_t*>(dv_s + (g + 8 * row) * DP + col) = pack_bf16x2(x0, x1);
          }
        }
      }
      __syncwarp();
      // the dv rows, coalesced: the bins' cotangent (zero for a frozen step)
      bf16* dvrow = a.dvbuf + ((size_t)tile0 * a.steps + t) * C;
      const int nrows = rays - tile0 < TILE_RAYS ? (int)(rays - tile0) : TILE_RAYS;
#pragma unroll 4
      for (int r = 0; r < nrows; ++r)
        for (int c8 = lane; c8 < groups; c8 += 32)
          *reinterpret_cast<uint4*>(dvrow + (size_t)r * a.steps * C + c8 * 8) =
              *reinterpret_cast<const uint4*>(dv_s + r * DP + c8 * 8);
      // the gather backward, a ray per lane pair: taps reloaded, v_t
      // re-blended, the per-tap dots into the coordinate cotangent
      bf16* vrow = a.vbuf + rsp * VW;
      if (actp) {
        for (int view = 0; view < NS; ++view) {
          const float* pj = a.proj + ((size_t)sbp * NS + view) * 16;
          const Projected pq = project_point(pj, cx, cy, cz);
          const Taps tp = bilinear_taps(pq.gx, pq.gy, a.H, a.W);
          const bf16* base = a.feat + ((size_t)sbp * NS + view) * a.H * a.W * C;
          float dot[4] = {0.f, 0.f, 0.f, 0.f};
          for (int k0 = 0; k0 < mine; k0 += GATHER_ITEMS) {
            uint4 tv[GATHER_ITEMS][4];
#pragma unroll
            for (int k = 0; k < GATHER_ITEMS; ++k)
              if (k0 + k < mine) load_taps(base + (ph + 2 * (k0 + k)) * 8, tp, C, tv[k]);
#pragma unroll
            for (int k = 0; k < GATHER_ITEMS; ++k) {
              if (k0 + k >= mine) break;
              const int ch = (ph + 2 * (k0 + k)) * 8;
              float f[4][8], dvv[8], val[8];
#pragma unroll
              for (int j = 0; j < 4; ++j) unpack8(tv[k][j], f[j]);
              load16_shared(dv_s + pr * DP + ch, dvv);
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                val[j] = blend4(f[0][j], f[1][j], f[2][j], f[3][j], tp);
#pragma unroll
                for (int m = 0; m < 4; ++m) dot[m] = fmaf(dvv[j], f[m][j], dot[m]);
              }
              if (NS == 1) {
                store16(vrow + ch, val);
              } else {  // v_t: the views' float32 sum, then the mean, as the forward
                float* va = vacc + pr * C + ch;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  if (view == 0) va[j] = val[j];
                  else if (view < NS - 1) va[j] = __fadd_rn(va[j], val[j]);
                  else val[j] = __fmul_rn(__fadd_rn(va[j], val[j]), inv_ns);
                }
                if (view == NS - 1) store16(vrow + ch, val);
              }
            }
          }
#pragma unroll
          for (int m = 0; m < 4; ++m) dot[m] += __shfl_xor_sync(pair, dot[m], 1);
          const float2 dgrid = tap_coord_grad(dot[0], dot[1], dot[2], dot[3], tp, pq.gx, pq.gy,
                                              a.H, a.W);
          const float3 dw = project_point_bwd(pj, pq, dgrid);
          gcx += dw.x;
          gcy += dw.y;
          gcz += dw.z;
        }
      } else if (vp) {  // a frozen step: v_t = 0 beside its zero dgates
        for (int k = 0; k < mine; ++k)
          *reinterpret_cast<uint4*>(vrow + (ph + 2 * k) * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncwarp();  // dv_s, vacc and ray_s are rewritten by the next step
    }
    if (vp && ph == 0) {
      a.dcoords0[rp * 3] = gcx;
      a.dcoords0[rp * 3 + 1] = gcy;
      a.dcoords0[rp * 3 + 2] = gcz;
      a.drds[rp * 3] = grx;
      a.drds[rp * 3 + 1] = gry;
      a.drds[rp * 3 + 2] = grz;
    }
  }
  __syncthreads();
  // the CTA's partial sums: each output's lane-owned slots, warps in order,
  // then the owning lanes in order
  const int nout = 5 * HP + 1;
  for (int o = threadIdx.x; o < nout; o += blockDim.x) {
    int slot, l0 = 0, dl = 1, nl = 32;
    if (o < 4 * HP) {  // dbias: permuted column (4 blk + k) 8 + 2 q + parity
      slot = ((o / UNIT_BLOCK) * 2 + (o & 1)), l0 = (o % UNIT_BLOCK) >> 1, dl = 4, nl = 8;
    } else if (o < 5 * HP) {  // dw_out: unit blk 8 + 2 q + parity
      const int u = o - 4 * HP;
      slot = OWN_DW + 2 * (u / UNIT_BLOCK) + (u & 1), l0 = (u % UNIT_BLOCK) >> 1, dl = 4, nl = 8;
    } else {
      slot = OWN_DB;
    }
    float sum = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float* ow = reinterpret_cast<const float*>(warp0 + w * wbytes + own_offset(C, NS)) +
                        slot * 32;
      for (int l = 0; l < nl; ++l) sum += ow[l0 + l * dl];
    }
    a.part[(size_t)blockIdx.x * nout + o] = sum;
  }
}

template <int NG>
static int launch_tile_bwd(TileBwdArgs a, cudaStream_t s, int* ctas) {
  const int HP = 16 * NG;
  const long long tiles = ((long long)a.SB * a.R + TILE_RAYS - 1) / TILE_RAYS;
  int warps = 0, e;
  size_t smem = 0;
  for (int wsm = 1; wsm >= 0 && !warps; --wsm) {
    a.wih_smem = wsm && (size_t)4 * HP * padded_channels(a.C) * 2 <= WIH_SMEM_MAX;
    if (wsm && !a.wih_smem) continue;
    if ((e = tile_warps(lstm_march_tile_bwd_kernel<NG>, tiles,
                        tile_bwd_shared(a.C, HP, a.wih_smem), tile_bwd_warp(a.C, a.NS, HP),
                        &warps, &smem)))
      return e;
  }
  if (!warps) return (int)cudaErrorInvalidValue;
  *ctas = (int)((tiles + warps - 1) / warps);
  lstm_march_tile_bwd_kernel<NG><<<(unsigned)*ctas, warps * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The bf16 backward: the walk, the latent cotangent through the bins, the
// partial sums' reduction.  dW_ih and dW_hh follow as the wrapper's wgrad
// over vbuf and dgbuf.  `part` holds (SB * R + 15) / 16 rows of 5 HP + 1.
extern "C" int avr_lstm_march_tiles_bwd(
    const void* proj, const void* rds, const void* feat, const void* wihT, const void* whhT,
    const void* w_out, const void* aux, const void* gout, void* dcoords0, void* drds, void* vbuf,
    void* dgbuf, void* dvbuf, void* pts, void* part, void* dfeat, void* ints, void* partials,
    void* dbias, void* dw_out, void* db_out, int SB, int R, int NS, int H, int W, int C,
    int hid, int steps, float clamp, void* stream) {
  if (hid < 1 || hid > MAX_HIDDEN || C % 8) return (int)cudaErrorInvalidValue;
  TileBwdArgs a;
  a.proj = (const float*)proj; a.rds = (const float*)rds; a.feat = (const bf16*)feat;
  a.wihT = (const uint4*)wihT; a.whhT = (const uint4*)whhT; a.w_out = (const float*)w_out;
  a.aux = (const float*)aux; a.gout = (const float*)gout; a.dcoords0 = (float*)dcoords0;
  a.drds = (float*)drds; a.vbuf = (bf16*)vbuf; a.dgbuf = (bf16*)dgbuf; a.dvbuf = (bf16*)dvbuf;
  a.pts = (float*)pts; a.part = (float*)part;
  a.SB = SB; a.R = R; a.NS = NS; a.H = H; a.W = W; a.C = C; a.hid = hid; a.steps = steps;
  a.clamp = clamp; a.wih_smem = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int HP = padded_hidden(hid);
  int ctas = 0, e;
  switch (HP / 16) {
    case 1: e = launch_tile_bwd<1>(a, s, &ctas); break;
    case 2: e = launch_tile_bwd<2>(a, s, &ctas); break;
    case 3: e = launch_tile_bwd<3>(a, s, &ctas); break;
    default: e = launch_tile_bwd<4>(a, s, &ctas); break;
  }
  if (e) return e;
  march_bins_bf16((const float*)pts, (const float*)proj, (const bf16*)dvbuf, (bf16*)dfeat, ints,
                  partials, SB * NS, NS, H, W, C, R * steps, s);
  lstm_march_partials_kernel<<<(5 * HP + 1 + 127) / 128, 128, 0, s>>>(
      (const float*)part, ctas, HP, (float*)dbias, (float*)dw_out, (float*)db_out);
  return (int)cudaGetLastError();
}
