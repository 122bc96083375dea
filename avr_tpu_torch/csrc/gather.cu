// K1: bilinear latent gather, forward and backward; K5: the same gather at
// the projection of world points, forward and backward.
//
// K1 replaces avr_tpu/ops/pallas/gather.py:395 gather_bilinear_windowed
// (forward) and its VJP _wbwd (gather.py:447, kernel math :102-151), and
// with them gather.py:164 gather_bilinear and its VJP _bwd (:207), the same
// function on the full map.  Semantics: F.grid_sample(align_corners=True,
// padding_mode="border") on an NHWC map, float32 blend, output in the map's
// dtype.
//
// K5 replaces gather.py:642 gather_bilinear_projected (forward, call :669)
// and its VJP _pbwd (:699, call :712): world points (B, N, 3) and each
// view's 16 packed projection scalars in, the grid computed in the kernel
// (project_point, common.cuh) and K1's gather at it.  The projection
// scalars get no cotangent (cameras are conditioning, as in the TPU
// kernel).
//
// Forward (K1 and K5, one kernel: gather_fwd_tile_kernel<PROJ, T>).  Bound
// on H100: bytes, the output's (band: 84 MB written against a 4.2 MB
// latent that stays in L2; 0.0265 ms at 3.35 TB/s, which a store-only
// kernel on an H100 80GB HBM3 at 700 W also takes).  The TPU kernel's
// one-hot MXU selectors and row windows are not needed: a tap is a plain
// load.  One thread a 16-byte channel group (every thread computing its
// point's taps, or, for K5, 4 points a CTA projected by 4 threads while
// 252 wait) took as long at single-pixel points, every tap in L1, as at
// ray-shaped and uniform ones (~0.051 ms; gather_turns.py at the repo's
// root): instructions and latency held it, not the taps' L2 traffic.  So:
//   - one CTA a tile of P consecutive points of one view (P = 64 at C =
//     512 bf16: 4,096 16-byte groups, 16 a thread; fewer, down to 16, where
//     the launch would give an SM less than two CTAs: ops/kernels/gather.py
//     fwd_plan).  Thread p computes point p's taps once (K5: projects it
//     first), into shared memory; one barrier a tile.  The loop's index
//     math is 32-bit, stepped by adding; a tile's base offsets are formed
//     once as size_t.
//   - lanes own consecutive channel groups of a point, so every tap load
//     and store is a coalesced 16-byte access; each thread has two items'
//     eight tap loads in flight, through the read-only path so that a
//     ray's samples, which share taps, hit L1.
//   - four CTAs an SM (64 registers a thread): one CTA's taps are computed
//     while the others stream.  CTAs that walked several tiles (the next
//     tile's taps prepared as the current streamed) were slower in
//     development builds at every grid tried: the block scheduler balances
//     one-tile CTAs over the SMs, a fixed grid leaves some SMs one CTA more.
//   - the output goes out by streaming 16-byte stores (st.global.cs),
//     which were faster in development builds than plain stores and than
//     staging the tile in shared memory for one cp.async.bulk store.
// Its float32 blend rounds each operation on its own (bilinear_taps,
// blend4, project_point), so the output equals the plain version's bit for
// bit in both dtypes.
//
// Backward (K1 and K5, one design).  Bound on H100: bytes, the function's
// own: g, the map and the coords or points in, dfeat in the map's dtype and
// the coordinate cotangent out (~0.11 ms at 4 x 81,920 points, bf16).  The
// semantics are the TPU kernel's: dfeat = sum over (point, tap) of
// round(w) * round(g) (w and g rounded to the map's dtype), float32 sums
// cast to the map's dtype once; the coordinate cotangent from the per-tap
// dots <g, f_tap> with the strict live mask on the unclamped coordinate.
// The TPU kernel adds a one-hot product per point block into a VMEM-resident
// map; here a scatter of w * g into device memory would need float atomics,
// which contend where a ray's samples share pixels and sum in an order that
// changes from run to run.  Instead the map is cut into TILE x TILE pixel
// tiles and each tile's sums are owned by one CTA:
//
//   1. front (one warp per point): the taps, the four dots, the coordinate
//      cotangent (K5: chained through the projection to the world point).
//   2. a stable counting sort of (point, tile) entries into bins, one bin a
//      (view, tile); a point is listed in every tile its four taps touch
//      (one, or two or four at a tile edge):
//      count   (one thread a point, SEG points a CTA): each CTA's count in
//              each tile its points touch, by integer atomics into a zeroed
//              (bin, CTA) histogram in device memory;
//      scan    (one CTA a bin): each CTA's offset within the bin, and the
//              bin's size;
//      plan    (one CTA): bin starts, and each bin's chunks (below);
//      scatter (as count): each entry's place, ranked by point within its
//              CTA by a bitonic sort of the CTA's at most 4 SEG tile keys in
//              shared memory (whatever the map's tile count), so every bin
//              lists its points in ascending order.
//   3. accumulate (one CTA a (bin chunk, channel slice of SLICE channels)):
//      the chunk's entries in bin order, each adding round(w) * g to those
//      of its taps that lie in the tile; the tile's sums stay on the chip
//      (registers or shared memory), owned by fixed threads, so no two
//      threads add to one address and every pixel-channel sum runs in one
//      fixed order.  bf16 maps (the main path): the sum is a one-hot
//      product, as on the TPU, on the tensor cores: S (64 pixels x 16
//      entries, the rounded weights) times G (16 entries x SLICE, g) by
//      mma.sync, warp w owning pixels 16 w .. 16 w + 15 of the tile in
//      float32 registers; bf16 operands make each product exact.  float32
//      maps: a float32 tile in shared memory, one thread a channel (float32
//      operands on the tensor cores would round to TF32).  A bin in one
//      chunk writes its tile once, in the map's dtype; a longer bin's chunks
//      write float32 partial tiles, which
//   4. reduce adds in chunk order and writes once.  No float atomics: dfeat
//      and the coordinate cotangent are bit for bit the same launch to
//      launch.
//
// Choices.  TILE 8: a 64 x 64 latent has 64 tiles a view, and a point
// straddles a tile edge with odds ~1/8 per axis (~1.27 entries a point at
// uniform coordinates).  SLICE 128: 4 accumulate CTAs a bin of a 512-wide
// latent, 64 x 128 float32 sums a CTA (32 KB: 64 registers a thread of the
// mma kernel's 128, or the float32 kernel's shared tile).  The mma kernel
// stages 128 entries at once (their g rows by cp.async, 8 products: the
// latency of the loads is paid once per 128 entries).  SEG 256 points a
// sort CTA: its at most 1,024 keys (8 KB of shared memory; ~325 at uniform
// points, sorted as 512) sort in at most 55 compare-and-swap steps, and a
// key's rank is a binary search; no shared array grows with the map (a
// per-warp count of every tile of the view, as a first version kept, held
// 1,024 tiles in 48 KB).
// The entries are int32: 4 B N < 2^31 (ops/kernels/gather.py checks it).
// Chunks: a bin of more than CHUNK_MIN entries
// wants ceil(n / CHUNK_MIN) chunks; the chunks of all split bins share a
// budget of PARTIAL_CHUNKS partial tiles (16.8 MB of float32 scratch at
// C = 512), cut pro rata when exceeded (then many bins are long and the
// card is full anyway).  The accumulate grid is fixed by the shapes, (bins
// + PARTIAL_CHUNKS) x slices, and CTAs past the plan's chunk count exit.
// The bin sizes never leave the device.

#include "bins.cuh"

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 8;                // map tile side, pixels
constexpr int SLICE = 128;             // channels of one accumulate CTA
constexpr int SEG = 256;               // points of one count / scatter CTA
constexpr int CHUNK_MIN = 2048;        // a bin longer than this is split
constexpr int PARTIAL_CHUNKS = 128;    // partial tiles of split bins, at most

// One point's coordinate cotangent by a whole warp, from the per-tap dots
// <g, f_tap> over its C channels; returned to every lane.
template <typename T>
__device__ __forceinline__ float2 gather_point_dgrid(const T* fb, const T* gp, const Taps& tp,
                                                     float gx, float gy, int H, int W, int C,
                                                     int lane) {
  constexpr int V = Vec16<T>::N;
  const int idx[4] = {tp.i00, tp.i01, tp.i10, tp.i11};
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ch = lane * V; ch < C; ch += 32 * V) {
    float gv[V], f[V];
    load16(gp + ch, gv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      load16(fb + (size_t)idx[k] * C + ch, f);
#pragma unroll
      for (int j = 0; j < V; ++j) dot[k] = fmaf(gv[j], f[j], dot[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dot[k] = warp_sum(dot[k]);
  return tap_coord_grad(dot[0], dot[1], dot[2], dot[3], tp, gx, gy, H, W);
}

// ---------------------------------------------------------------------------
// The binned accumulation of dfeat, shared by K1's and K5's backward
// ---------------------------------------------------------------------------

// The taps of point `pt` (flat over views): K1 reads its grid coordinate,
// K5 and K3 project their world point through the view's scalars `p_s`.
template <bool PROJ>
__device__ __forceinline__ Taps point_taps(const float* src, const float* p_s, size_t pt, int H,
                                           int W) {
  if (PROJ) {
    const float* x = src + pt * 3;
    const Projected q = project_point(p_s, x[0], x[1], x[2]);
    return bilinear_taps(q.gx, q.gy, H, W);
  }
  const float2 c = reinterpret_cast<const float2*>(src)[pt];
  return bilinear_taps(c.x, c.y, H, W);
}

// A point's tiles as one code: the tile of its top-left tap (ty0 * TX +
// tx0) << 2, bit 1 if its lower taps lie one tile row down, bit 0 if its
// right taps lie one tile column right.  Its entries, in slot order: the
// tile, the one right (bit 0), the one down (bit 1), the one down-right
// (both).
__device__ __forceinline__ int tile_code(const Taps& tp, int W, int TX) {
  const int y0 = tp.i00 / W, x0 = tp.i00 - y0 * W;
  const int x1 = tp.i01 - y0 * W, y1 = tp.i10 / W;
  const int tx0 = x0 / TILE, ty0 = y0 / TILE;
  const int sx = x1 / TILE != tx0, sy = y1 / TILE != ty0;
  return ((ty0 * TX + tx0) << 2) | (sy << 1) | sx;
}

// Tile of entry slot k of `code` (-1 if the point has no such entry).
__device__ __forceinline__ int code_tile(int code, int k, int TX) {
  const int t = code >> 2, sx = code & 1, sy = (code >> 1) & 1;
  switch (k) {
    case 0: return t;
    case 1: return sx ? t + 1 : -1;
    case 2: return sy ? t + TX : -1;
    default: return sx && sy ? t + TX + 1 : -1;
  }
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum.  `sh` holds 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    sh[lane] = s;
  }
  __syncthreads();
  const int before = warp ? sh[warp - 1] : 0;
  *total = sh[nw - 1];
  __syncthreads();  // sh is reused by the next call
  return before + x - v;
}

// Sort layout (ints): hist [NB][nseg] (counts, then offsets within the
// bin), totals [NB], the plan (start [NB], chunks [NB], wstart [NB + 1],
// pslot [NB]), entries [4 B N].  NB = B * tiles a view, bin = view * tiles
// + tile.
struct BinPlan {
  const int* start;   // first entry of each bin
  const int* chunks;  // chunks of each bin (1: written directly)
  const int* wstart;  // first work item of each bin; wstart[NB] = items
  const int* pslot;   // first partial tile of a split bin
  __device__ BinPlan(const int* plan, int NB)
      : start(plan), chunks(plan + NB), wstart(plan + 2 * NB), pslot(plan + 3 * NB + 1) {}
};

// The point set (and cotangent rows) of map b: K1 and K5 have one a map;
// K3's SHARED maps come `views` to a scene, all reading the scene's ray-steps.
template <bool SHARED> __device__ __forceinline__ size_t point_set(int b, int views) {
  return (size_t)(SHARED ? b / views : b);
}

// A sort block's entries ranked by tile, independent of the map's tile
// count: each of its SEG points' (at most 4) entries gets the key (tile <<
// 10) | (4 * local point + slot); the block's keys are compacted (a block
// scan of each thread's count, in thread order) into the first `total`
// places and sorted by a bitonic network over the least power of two that
// holds them (the rest ~0), so by tile and, within a tile, by point (a point
// has at most one entry a tile, and the low bits make every key unique: the
// order is total, the same on every run).  After it, keys[i]'s rank in its
// tile is i less the tile's first position.  Returns `total`.
constexpr int SORT_KEYS = 4 * SEG;
static_assert(SORT_KEYS <= 1024, "a key's low 10 bits hold its entry");

template <bool PROJ, bool SHARED>
__device__ __forceinline__ int sort_block_entries(unsigned long long* keys, int* sh,
                                                  const float* __restrict__ src, const float* p_s,
                                                  int b, int seg, int H, int W, int N, int TX,
                                                  int views) {
  const int tid = threadIdx.x, n = seg * SEG + tid;
  const int code =
      n < N ? tile_code(point_taps<PROJ>(src, p_s, point_set<SHARED>(b, views) * N + n, H, W),
                        W, TX)
            : -1;
  int tile[4], mine = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    tile[k] = code < 0 ? -1 : code_tile(code, k, TX);
    mine += tile[k] >= 0;
  }
  int total;
  int at = block_exclusive_scan(mine, sh, &total);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (tile[k] >= 0) keys[at++] = ((unsigned long long)tile[k] << 10) | (unsigned)(4 * tid + k);
  int size_max = 1;
  while (size_max < total) size_max <<= 1;
  for (int i = total + tid; i < size_max; i += SEG) keys[i] = ~0ull;
  for (int size = 2; size <= size_max; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int p = tid; p < size_max / 2; p += SEG) {
        const int i = 2 * p - (p & (stride - 1)), j = i + stride;
        const unsigned long long a = keys[i], c = keys[j];
        if ((a > c) == ((i & size) == 0)) {
          keys[i] = c;
          keys[j] = a;
        }
      }
    }
  __syncthreads();
  return total;
}

// The first position of tile `tile`'s keys among the `total` sorted keys.
__device__ __forceinline__ int tile_first(const unsigned long long* keys, int total,
                                          unsigned long long tile) {
  int lo = 0, hi = total;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((keys[mid] >> 10) < tile) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// count: block (seg, view) adds its SEG points' entries to their tiles'
// counts for the block in hist, zeroed first, by integer atomics (a count
// has no order; the array is the bins' counts by sort block, not a shared
// array sized by the map).
template <bool PROJ, bool SHARED>
__global__ void __launch_bounds__(SEG)
gather_bin_count_kernel(const float* __restrict__ src, const float* __restrict__ proj,
                        int* __restrict__ hist, int H, int W, int N, int TX, int T, int nseg,
                        int views) {
  __shared__ float p_s[16];
  const int b = blockIdx.y, seg = blockIdx.x, tid = threadIdx.x;
  if (PROJ && tid < 16) p_s[tid] = proj[(size_t)b * 16 + tid];
  __syncthreads();
  const int n = seg * SEG + tid;
  if (n >= N) return;
  const int code =
      tile_code(point_taps<PROJ>(src, p_s, point_set<SHARED>(b, views) * N + n, H, W), W, TX);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = code_tile(code, k, TX);
    if (x >= 0) atomicAdd(&hist[((size_t)b * T + x) * nseg + seg], 1);
  }
}

// scan: block `bin` turns its nseg counts into offsets within the bin, and
// writes the bin's size.
__global__ void __launch_bounds__(THREADS)
gather_bin_scan_kernel(int* __restrict__ hist, int* __restrict__ totals, int nseg) {
  __shared__ int sh[32];
  const int bin = blockIdx.x;
  int* h = hist + (size_t)bin * nseg;
  int carry = 0;
  for (int base = 0; base < nseg; base += THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < nseg ? h[i] : 0;
    int tot;
    const int ex = block_exclusive_scan(v, sh, &tot);
    if (i < nseg) h[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) totals[bin] = carry;
}

__device__ __forceinline__ int wanted_chunks(int n) {
  return n > CHUNK_MIN ? (n + CHUNK_MIN - 1) / CHUNK_MIN : 1;
}

// plan (one block): each bin's first entry; its chunks (wanted_chunks, and
// when the split bins want more than PARTIAL_CHUNKS in all, each split
// bin's share of them, floor(wanted * PARTIAL_CHUNKS / all wanted), at least
// 1); its first work item, and a split bin's first partial tile.
__global__ void __launch_bounds__(1024)
gather_bin_plan_kernel(const int* __restrict__ totals, int* __restrict__ plan, int NB) {
  __shared__ int sh[32];
  int* start = plan;
  int* chunks = plan + NB;
  int* wstart = plan + 2 * NB;
  int* pslot = plan + 3 * NB + 1;
  int carry = 0, wanted = 0;
  for (int base = 0; base < NB; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int n = i < NB ? totals[i] : 0;
    int tot;
    const int ex = block_exclusive_scan(n, sh, &tot);
    if (i < NB) start[i] = carry + ex;
    carry += tot;
    const int d = i < NB ? wanted_chunks(n) : 1;
    block_exclusive_scan(d > 1 ? d : 0, sh, &tot);
    wanted += tot;
  }
  int witems = 0, pslots = 0;
  for (int base = 0; base < NB; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int d = i < NB ? wanted_chunks(totals[i]) : 1;
    const int k = d == 1 || wanted <= PARTIAL_CHUNKS
                      ? d : max(1, (int)((long long)d * PARTIAL_CHUNKS / wanted));
    int tot;
    const int wex = block_exclusive_scan(i < NB ? k : 0, sh, &tot);
    if (i < NB) {
      chunks[i] = k;
      wstart[i] = witems + wex;
    }
    witems += tot;
    const int pex = block_exclusive_scan(i < NB && k > 1 ? k : 0, sh, &tot);
    if (i < NB) pslot[i] = pslots + pex;
    pslots += tot;
  }
  if (threadIdx.x == 0) wstart[NB] = witems;
}

// scatter: block (seg, view) places its SEG points' entries: an entry's
// rank in its bin counts the block's earlier points with an entry there,
// its position among the sorted keys less its tile's first.
template <bool PROJ, bool SHARED>
__global__ void __launch_bounds__(SEG)
gather_bin_scatter_kernel(const float* __restrict__ src, const float* __restrict__ proj,
                          const int* __restrict__ hist, const int* __restrict__ plan,
                          int* __restrict__ entries, int H, int W, int N, int TX, int T, int nseg,
                          int NB, int views) {
  __shared__ unsigned long long keys[SORT_KEYS];
  __shared__ int sh[32];
  __shared__ float p_s[16];
  const int b = blockIdx.y, seg = blockIdx.x, tid = threadIdx.x;
  if (PROJ && tid < 16) p_s[tid] = proj[(size_t)b * 16 + tid];
  __syncthreads();
  const int total = sort_block_entries<PROJ, SHARED>(keys, sh, src, p_s, b, seg, H, W, N, TX,
                                                     views);
  const BinPlan pl(plan, NB);
  for (int i = tid; i < total; i += SEG) {
    const unsigned long long key = keys[i], tile = key >> 10;
    const size_t bin = (size_t)b * T + tile;
    const int n = seg * SEG + (int)(key & 1023) / 4;
    entries[pl.start[bin] + hist[bin * nseg + seg] + i - tile_first(keys, total, tile)] = n;
  }
}

// One 32-bit word of T at p: 2 bf16 or 1 float32 channels.
template <typename T> struct Word;
template <> struct Word<bf16> {
  static constexpr int N = 2;
  __device__ static void store(bf16* p, const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};
template <> struct Word<float> {
  static constexpr int N = 1;
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};

template <typename T> __host__ __device__ constexpr int reduce_threads() {
  return SLICE / Word<T>::N;
}

// The (item, slice) of an accumulate block: the item is a chunk of a bin
// (the last bin whose first item is at or below it).
struct AccItem {
  int bin, b, y_org, x_org, chunks, chunk, e0, e1;
  __device__ AccItem(const BinPlan& pl, const int* totals, int item, int NB, int TX, int T_) {
    int lo = 0, hi = NB - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pl.wstart[mid] <= item) lo = mid;
      else hi = mid - 1;
    }
    bin = lo;
    b = bin / T_;
    const int t = bin - b * T_;
    y_org = t / TX * TILE;
    x_org = t % TX * TILE;
    const int n = totals[bin];
    chunks = pl.chunks[bin];
    chunk = item - pl.wstart[bin];
    const int len = (n + chunks - 1) / chunks;
    e0 = pl.start[bin] + chunk * len;
    e1 = min(pl.start[bin] + n, e0 + len);
  }
};

// Tile pixel (0 .. TILE^2 - 1 in the tile at y_org, x_org) of flat pixel
// i, or -1 if it lies outside or its rounded weight w is 0.
__device__ __forceinline__ int tile_pixel(int i, float w, int W, int y_org, int x_org) {
  const int y = i / W, dy = y - y_org, dx = i - y * W - x_org;
  return w != 0.f && dy >= 0 && dy < TILE && dx >= 0 && dx < TILE ? dy * TILE + dx : -1;
}

// --- bf16 maps: the accumulation as a one-hot product on the tensor cores

static __device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
static __device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> static __device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int N> static __device__ __forceinline__ void cp_async_wait_upto(int n) {
  if constexpr (N > 0) {
    if (n >= N) return cp_async_wait_group<N>();
    return cp_async_wait_upto<N - 1>(n);
  } else {
    cp_async_wait_group<0>();
  }
}

constexpr int MMA_THREADS = 128;  // 4 warps: 16 tile pixels x SLICE channels each
constexpr int KSTEP = 16;         // entries a product
constexpr int MMA_BATCH = 128;    // entries staged at once: 8 products
// row pitches (bf16) that keep ldmatrix free of bank conflicts: 272 bytes
constexpr int S_LD = MMA_BATCH + 8;
constexpr int G_LD = SLICE + 8;
constexpr int MMA_SMEM = (TILE * TILE * S_LD + MMA_BATCH * G_LD) * 2 + MMA_BATCH * 4;

// mma accumulate (bf16): block (item, slice).  Per batch of MMA_BATCH
// entries: cp.async brings their g rows (the slice's channels) into shared
// memory, one commit group per KSTEP entries, while each thread builds one
// entry's column of the one-hot weight matrix S (64 pixels x MMA_BATCH
// entries, the rounded weights at its taps in the tile, zero elsewhere);
// then warp w adds S[16 w .. 16 w + 15] x G into its float32 accumulators
// (16 pixels x SLICE channels) by mma.sync, KSTEP entries a product, in bin
// order.  w and g are bf16 values, so each product is exact and the sums
// are float32, in an order the instruction fixes.  A non-finite g reaches
// every pixel of the tile (0 * inf), as in the TPU kernel's one-hot product.
template <bool PROJ, bool SHARED>
__global__ void __launch_bounds__(MMA_THREADS)
gather_bin_mma_kernel(const float* __restrict__ src, const float* __restrict__ proj,
                      const bf16* __restrict__ g, const int* __restrict__ entries,
                      const int* __restrict__ totals, const int* __restrict__ plan,
                      bf16* __restrict__ dfeat, float* __restrict__ partials, int H, int W, int C,
                      int N, int TX, int T_, int NB, int views) {
  constexpr int STEPS = MMA_BATCH / KSTEP, PIECES = SLICE / 8;  // 16-byte pieces a g row
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16(*S)[S_LD] = reinterpret_cast<bf16(*)[S_LD]>(mma_smem);
  bf16(*G)[G_LD] = reinterpret_cast<bf16(*)[G_LD]>(mma_smem + TILE * TILE * S_LD * 2);
  int* st_pt = reinterpret_cast<int*>(mma_smem + (TILE * TILE * S_LD + MMA_BATCH * G_LD) * 2);
  __shared__ float p_s[16];
  const BinPlan pl(plan, NB);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if ((int)blockIdx.x >= pl.wstart[NB]) return;
  const AccItem it(pl, totals, blockIdx.x, NB, TX, T_);
  const int c0 = blockIdx.y * SLICE;
  if (PROJ && tid < 16) p_s[tid] = proj[(size_t)it.b * 16 + tid];
  const size_t ps = point_set<SHARED>(it.b, views);
  const bf16* gb = g + ps * N * C;
  float d[SLICE / 8][4];
#pragma unroll
  for (int j = 0; j < SLICE / 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
  for (int base = it.e0; base < it.e1; base += MMA_BATCH) {
    __syncthreads();  // p_s is loaded; the last batch's S and G are consumed
    const int cnt = min(MMA_BATCH, it.e1 - base);
    for (int i = tid; i < TILE * TILE * MMA_BATCH / 8; i += MMA_THREADS)
      *reinterpret_cast<uint4*>(&S[i / (MMA_BATCH / 8)][i % (MMA_BATCH / 8) * 8]) =
          make_uint4(0u, 0u, 0u, 0u);
    const int n = tid < cnt ? entries[base + tid] : 0;
    st_pt[tid] = n;
    __syncthreads();
    for (int s = 0; s < STEPS; ++s) {
      for (int i = tid; i < KSTEP * PIECES; i += MMA_THREADS) {
        const int r = s * KSTEP + i / PIECES, ch = c0 + i % PIECES * 8;
        const bool ok = r < cnt && ch < C;
        cp_async16_zfill(&G[r][i % PIECES * 8], ok ? gb + (size_t)st_pt[r] * C + ch : g, ok);
      }
      cp_async_commit_group();
    }
    if (tid < cnt) {
      const Taps tp = point_taps<PROJ>(src, p_s, ps * N + n, H, W);
      const int idx[4] = {tp.i00, tp.i01, tp.i10, tp.i11};
      const float w[4] = {tp.w00, tp.w01, tp.w10, tp.w11};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16 wr = __float2bfloat16_rn(w[j]);
        const int px = tile_pixel(idx[j], __bfloat162float(wr), W, it.y_org, it.x_org);
        if (px >= 0) S[px][tid] = wr;
      }
    }
    const int steps = (cnt + KSTEP - 1) / KSTEP;
    for (int s = 0; s < steps; ++s) {
      cp_async_wait_upto<STEPS - 1>(STEPS - 1 - s);
      __syncthreads();  // this product's G rows and every column of S are in
      uint32_t a[4];
      ldsm_x4(a, &S[16 * warp + (lane & 7) + (lane >> 3 & 1) * 8][s * KSTEP + (lane >> 4) * 8],
              false);
#pragma unroll
      for (int j = 0; j < SLICE / 16; ++j) {
        uint32_t bb[4];
        ldsm_x4(bb, &G[s * KSTEP + (lane & 7) + (lane >> 3 & 1) * 8][j * 16 + (lane >> 4) * 8],
                true);
        mma_m16n8k16(d[2 * j], a, bb[0], bb[1]);
        mma_m16n8k16(d[2 * j + 1], a, bb[2], bb[3]);
      }
    }
    cp_async_wait_group<0>();  // the zero-filled groups past the batch's products
  }
#pragma unroll
  for (int j = 0; j < SLICE / 8; ++j) {
    const int ch = c0 + j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lp = 16 * warp + (lane >> 2) + 8 * h;
      const int y = it.y_org + lp / TILE, x = it.x_org + lp % TILE;
      if (y >= H || x >= W || ch >= C) continue;
      if (it.chunks == 1)
        Word<bf16>::store(dfeat + (((size_t)it.b * H + y) * W + x) * C + ch, &d[j][2 * h]);
      else
        *reinterpret_cast<float2*>(
            partials + ((size_t)(pl.pslot[it.bin] + it.chunk) * TILE * TILE + lp) * C + ch) =
            make_float2(d[j][2 * h], d[j][2 * h + 1]);
    }
  }
}

// --- float32 maps: the accumulation in shared memory (float32 operands on
// the tensor cores would be rounded to TF32)

// accumulate (float32): block (item, slice), one thread a channel.  Per
// batch of SLICE entries the threads first compute the taps (tile pixels
// and weights) into shared memory, then every thread walks the batch in
// order over its channel of the shared tile.  The branches depend on the
// entry only, so a warp never diverges.
template <bool PROJ, bool SHARED>
__global__ void __launch_bounds__(SLICE)
gather_bin_accum_kernel(const float* __restrict__ src, const float* __restrict__ proj,
                        const float* __restrict__ g, const int* __restrict__ entries,
                        const int* __restrict__ totals, const int* __restrict__ plan,
                        float* __restrict__ dfeat, float* __restrict__ partials, int H, int W,
                        int C, int N, int TX, int T_, int NB, int views) {
  __shared__ float acc[TILE * TILE * SLICE];
  __shared__ int st_pt[SLICE];
  __shared__ int4 st_px[SLICE];
  __shared__ float4 st_w[SLICE];
  __shared__ float p_s[16];
  const BinPlan pl(plan, NB);
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= pl.wstart[NB]) return;
  const AccItem it(pl, totals, blockIdx.x, NB, TX, T_);
  const int ch = blockIdx.y * SLICE + tid;
  const bool live_ch = ch < C;
  if (PROJ && tid < 16) p_s[tid] = proj[(size_t)it.b * 16 + tid];
  const size_t ps = point_set<SHARED>(it.b, views);
  const float* gb = g + ps * N * C + ch;
  float* own = acc + tid;  // a thread reads and writes its own channel only
  for (int lp = 0; lp < TILE * TILE; ++lp) own[lp * SLICE] = 0.f;
  for (int base = it.e0; base < it.e1; base += SLICE) {
    __syncthreads();  // p_s is loaded; the last batch is done
    if (base + tid < it.e1) {
      const int n = entries[base + tid];
      const Taps tp = point_taps<PROJ>(src, p_s, ps * N + n, H, W);
      st_pt[tid] = n;
      st_px[tid] = make_int4(tile_pixel(tp.i00, tp.w00, W, it.y_org, it.x_org),
                             tile_pixel(tp.i01, tp.w01, W, it.y_org, it.x_org),
                             tile_pixel(tp.i10, tp.w10, W, it.y_org, it.x_org),
                             tile_pixel(tp.i11, tp.w11, W, it.y_org, it.x_org));
      st_w[tid] = make_float4(tp.w00, tp.w01, tp.w10, tp.w11);
    }
    __syncthreads();
    const int cnt = min(SLICE, it.e1 - base);
    for (int q = 0; q < cnt && live_ch; ++q) {
      const float gv = __ldg(gb + (size_t)st_pt[q] * C);
      const int4 px = st_px[q];
      const float4 w = st_w[q];
      if (px.x >= 0) own[px.x * SLICE] = __fmaf_rn(w.x, gv, own[px.x * SLICE]);
      if (px.y >= 0) own[px.y * SLICE] = __fmaf_rn(w.y, gv, own[px.y * SLICE]);
      if (px.z >= 0) own[px.z * SLICE] = __fmaf_rn(w.z, gv, own[px.z * SLICE]);
      if (px.w >= 0) own[px.w * SLICE] = __fmaf_rn(w.w, gv, own[px.w * SLICE]);
    }
  }
  if (!live_ch) return;
  for (int lp = 0; lp < TILE * TILE; ++lp) {
    const int y = it.y_org + lp / TILE, x = it.x_org + lp % TILE;
    if (y >= H || x >= W) continue;
    float* out = it.chunks == 1 ? dfeat + (((size_t)it.b * H + y) * W + x) * C + ch
                                : partials + ((size_t)(pl.pslot[it.bin] + it.chunk) * TILE *
                                              TILE + lp) * C + ch;
    *out = own[lp * SLICE];
  }
}

// reduce: block (bin, slice) of a split bin adds its partial tiles in chunk
// order and writes the tile once, in the map's dtype; a thread per (pixel
// group, channel word), REDUCE_ROWS pixels apart.
constexpr int REDUCE_ROWS = 4;
template <typename T>
__global__ void __launch_bounds__(reduce_threads<T>() * REDUCE_ROWS)
gather_bin_reduce_kernel(const int* __restrict__ plan, const float* __restrict__ partials,
                         T* __restrict__ dfeat, int H, int W, int C, int TX, int T_, int NB) {
  constexpr int VC = Word<T>::N;
  const BinPlan pl(plan, NB);
  const int bin = blockIdx.x, k = pl.chunks[bin];
  const int ch = blockIdx.y * SLICE + threadIdx.x * VC;
  if (k == 1 || ch >= C) return;
  const int b = bin / T_, t = bin - b * T_;
  const int y_org = t / TX * TILE, x_org = t % TX * TILE;
  const float* p0 = partials + (size_t)pl.pslot[bin] * TILE * TILE * C + ch;
#pragma unroll 4
  for (int lp = threadIdx.y; lp < TILE * TILE; lp += REDUCE_ROWS) {
    const int y = y_org + lp / TILE, x = x_org + lp % TILE;
    if (y >= H || x >= W) continue;
    float s[VC];
    for (int v = 0; v < VC; ++v) s[v] = p0[(size_t)lp * C + v];
    for (int j = 1; j < k; ++j)
      for (int v = 0; v < VC; ++v) s[v] += p0[((size_t)j * TILE * TILE + lp) * C + v];
    Word<T>::store(dfeat + (((size_t)b * H + y) * W + x) * C + ch, s);
  }
}

// Steps 2-4 of the backward: dfeat (B, H, W, C) in T from the cotangent g
// (B, N, C) at K1's coords (B, N, 2) or K5's points (B, N, 3) with proj
// (B, 16); SHARED (K3): points (B / views, N, 3) and g (B / views, N, C),
// each shared by `views` consecutive maps.  `ints` and `partials` are the
// wrapper's scratch (ops/kernels/gather.py bin_workspace).
template <typename T, bool PROJ, bool SHARED = false>
static void launch_bins(const void* src, const void* proj, const void* g, void* dfeat,
                        void* ints, void* partials, int B, int H, int W, int C, int N,
                        cudaStream_t s, int views = 1) {
  const int TX = (W + TILE - 1) / TILE, T_ = TX * ((H + TILE - 1) / TILE), NB = B * T_;
  const int nseg = (N + SEG - 1) / SEG, slices = (C + SLICE - 1) / SLICE;
  int* hist = (int*)ints;
  int* totals = hist + (size_t)NB * nseg;
  int* plan = totals + NB;
  int* entries = plan + 4 * NB + 1;
  const dim3 sort_grid((unsigned)nseg, (unsigned)B);
  cudaMemsetAsync(hist, 0, (size_t)NB * nseg * sizeof(int), s);
  gather_bin_count_kernel<PROJ, SHARED><<<sort_grid, SEG, 0, s>>>(
      (const float*)src, (const float*)proj, hist, H, W, N, TX, T_, nseg, views);
  gather_bin_scan_kernel<<<NB, THREADS, 0, s>>>(hist, totals, nseg);
  gather_bin_plan_kernel<<<1, 1024, 0, s>>>(totals, plan, NB);
  gather_bin_scatter_kernel<PROJ, SHARED><<<sort_grid, SEG, 0, s>>>(
      (const float*)src, (const float*)proj, hist, plan, entries, H, W, N, TX, T_, nseg, NB,
      views);
  const dim3 acc_grid((unsigned)(NB + PARTIAL_CHUNKS), (unsigned)slices);
  if constexpr (sizeof(T) == 2) {
    cudaFuncSetAttribute(gather_bin_mma_kernel<PROJ, SHARED>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);  // above 48 KB
    gather_bin_mma_kernel<PROJ, SHARED><<<acc_grid, MMA_THREADS, MMA_SMEM, s>>>(
        (const float*)src, (const float*)proj, (const bf16*)g, entries, totals, plan,
        (bf16*)dfeat, (float*)partials, H, W, C, N, TX, T_, NB, views);
  } else {
    gather_bin_accum_kernel<PROJ, SHARED><<<acc_grid, SLICE, 0, s>>>(
        (const float*)src, (const float*)proj, (const float*)g, entries, totals, plan,
        (float*)dfeat, (float*)partials, H, W, C, N, TX, T_, NB, views);
  }
  gather_bin_reduce_kernel<T><<<dim3((unsigned)NB, (unsigned)slices),
                                dim3(reduce_threads<T>(), REDUCE_ROWS), 0, s>>>(
      plan, (const float*)partials, (T*)dfeat, H, W, C, TX, T_, NB);
}

// K3's latent cotangent (csrc/bins.cuh): the march's ray-steps as SHARED
// projected points, bf16 and float32.
void march_bins_bf16(const float* points, const float* proj, const bf16* g, bf16* dfeat,
                     void* ints, void* partials, int maps, int views, int H, int W, int C, int N,
                     cudaStream_t s) {
  launch_bins<bf16, true, true>(points, proj, g, dfeat, ints, partials, maps, H, W, C, N, s,
                                views);
}
void march_bins_f32(const float* points, const float* proj, const float* g, float* dfeat,
                    void* ints, void* partials, int maps, int views, int H, int W, int C, int N,
                    cudaStream_t s) {
  launch_bins<float, true, true>(points, proj, g, dfeat, ints, partials, maps, H, W, C, N, s,
                                 views);
}

// ---------------------------------------------------------------------------
// Forward, K1 and K5: one tiled kernel (PROJ: K5's world points)
// ---------------------------------------------------------------------------

constexpr int FWD_THREADS = 256;
constexpr int FWD_CTAS_PER_SM = 4;   // the launch bound: 64 registers a thread
constexpr int FWD_MAX_POINTS = 256;  // points of a tile, at most: one a thread
constexpr int FWD_UNROLL = 2;        // channel groups a thread has in flight

// A point's four taps as the tile reads them: flat pixels and weights.
struct __align__(16) TapSlot {
  int4 idx;
  float4 w;
};

// 16 bytes through the read-only, L1-cached path, kept raw until the blend.
__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
template <typename T> __device__ __forceinline__ void unpack16(const uint4& v, float* out);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
template <> __device__ __forceinline__ void unpack16<bf16>(const uint4& v, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Point pt's taps: K1 at its grid coordinate, K5 at the projection of its
// world point through view b's 16 scalars (project_point), then
// bilinear_taps, as the plain version computes them.
template <bool PROJ>
__device__ __forceinline__ TapSlot tap_slot(const float* src, const float* proj, size_t pt,
                                            int b, int H, int W) {
  Taps t;
  if (PROJ) {
    float p[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) p[k] = __ldg(proj + (size_t)b * 16 + k);
    const Projected q =
        project_point(p, __ldg(src + pt * 3), __ldg(src + pt * 3 + 1), __ldg(src + pt * 3 + 2));
    t = bilinear_taps(q.gx, q.gy, H, W);
  } else {
    const float2 c = __ldg(reinterpret_cast<const float2*>(src) + pt);
    t = bilinear_taps(c.x, c.y, H, W);
  }
  TapSlot slot;
  slot.idx = make_int4(t.i00, t.i01, t.i10, t.i11);
  slot.w = make_float4(t.w00, t.w01, t.w10, t.w11);
  return slot;
}

// CTA t writes tile j = t % tpv of view b = t / tpv: points [j P, j P + P)
// of the view, the last tile short (tpv = ceil(N / P)).  Thread p < np
// computes point p's taps into shared memory; after the one barrier, item
// i of the tile is channel group i % G of point i / G (G = C / V), and
// thread tid takes items tid, tid + 256, ..., stepping its (point, group)
// by adding, FWD_UNROLL items' 4 tap loads at a time.
template <bool PROJ, typename T>
__global__ void __launch_bounds__(FWD_THREADS, FWD_CTAS_PER_SM)
gather_fwd_tile_kernel(const T* __restrict__ feat, const float* __restrict__ src,
                       const float* __restrict__ proj, T* __restrict__ out, int H, int W, int C,
                       int N, int P, int tpv) {
  constexpr int V = Vec16<T>::N, U = FWD_UNROLL;
  __shared__ TapSlot slots[FWD_MAX_POINTS];
  const int tid = threadIdx.x, G = C / V, t = blockIdx.x;
  const int b = t / tpv;
  const unsigned n0 = (unsigned)(t - b * tpv) * (unsigned)P;
  const int np = min(P, (int)((unsigned)N - n0));
  const size_t pt0 = (size_t)b * N + n0;
  if (tid < np) slots[tid] = tap_slot<PROJ>(src, proj, pt0 + tid, b, H, W);
  __syncthreads();
  const T* map = feat + (size_t)b * H * W * C;
  T* ob = out + pt0 * C;
  const int p_step = FWD_THREADS / G, g_step = FWD_THREADS - p_step * G;
  int p = tid / G, g = tid - p * G;
  while (p < np) {
    int pu[U], gu[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      pu[u] = p;
      gu[u] = g;
      p += p_step;
      g += g_step;
      if (g >= G) {
        g -= G;
        ++p;
      }
    }
    uint4 raw[U][4];
    float4 w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (pu[u] < np) {
        const TapSlot ts = slots[pu[u]];
        const T* base = map + gu[u] * V;
        raw[u][0] = ldg16(base + (size_t)(unsigned)ts.idx.x * C);
        raw[u][1] = ldg16(base + (size_t)(unsigned)ts.idx.y * C);
        raw[u][2] = ldg16(base + (size_t)(unsigned)ts.idx.z * C);
        raw[u][3] = ldg16(base + (size_t)(unsigned)ts.idx.w * C);
        w[u] = ts.w;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (pu[u] < np) {
        Taps tp;
        tp.w00 = w[u].x;
        tp.w01 = w[u].y;
        tp.w10 = w[u].z;
        tp.w11 = w[u].w;
        float t00[V], t01[V], t10[V], t11[V], r[V];
        unpack16<T>(raw[u][0], t00);
        unpack16<T>(raw[u][1], t01);
        unpack16<T>(raw[u][2], t10);
        unpack16<T>(raw[u][3], t11);
#pragma unroll
        for (int k = 0; k < V; ++k) r[k] = blend4(t00[k], t01[k], t10[k], t11[k], tp);
        // streaming store: the output is read by the next kernel, not this one
        uint4 v;
        store16(reinterpret_cast<T*>(&v), r);
        __stcs(reinterpret_cast<uint4*>(ob + (size_t)pu[u] * C + gu[u] * V), v);
      }
    }
  }
}

template <bool PROJ, typename T>
static int launch_fwd(const void* feat, const void* src, const void* proj, void* out, int B,
                      int H, int W, int C, int N, int P, cudaStream_t stream) {
  // a tile's taps live in slots[FWD_MAX_POINTS], one a thread
  if (P < 1 || P > FWD_MAX_POINTS) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;  // no point: nothing to launch
  const int tpv = (N + P - 1) / P;
  gather_fwd_tile_kernel<PROJ, T><<<(unsigned)B * tpv, FWD_THREADS, 0, stream>>>(
      (const T*)feat, (const float*)src, (const float*)proj, (T*)out, H, W, C, N, P, tpv);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

// Backward front: one warp per point writes its coordinate cotangent.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_bilinear_bwd_kernel(const T* __restrict__ feat, const float* __restrict__ coords,
                           const T* __restrict__ g, float* __restrict__ dcoords, int H, int W,
                           int C, int N, long long points) {
  const int lane = threadIdx.x & 31;
  const long long pt = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (pt >= points) return;  // whole warps leave together
  const int b = (int)(pt / N);
  const float2 gc = reinterpret_cast<const float2*>(coords)[pt];
  const float2 d = gather_point_dgrid(feat + (size_t)b * H * W * C, g + (size_t)pt * C,
                                      bilinear_taps(gc.x, gc.y, H, W), gc.x, gc.y, H, W, C, lane);
  if (lane == 0) reinterpret_cast<float2*>(dcoords)[pt] = d;
}

template <typename T>
static int launch_bwd(const void* feat, const void* coords, const void* g, void* dfeat,
                      void* dcoords, void* ints, void* partials, int B, int H, int W, int C,
                      int N, cudaStream_t stream) {
  const long long points = (long long)B * N;
  const long long blocks = (points * 32 + THREADS - 1) / THREADS;
  gather_bilinear_bwd_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)feat, (const float*)coords, (const T*)g, (float*)dcoords, H, W, C, N, points);
  launch_bins<T, false>(coords, nullptr, g, dfeat, ints, partials, B, H, W, C, N, stream);
  return (int)cudaGetLastError();
}

extern "C" int avr_gather_bilinear_bwd(const void* feat, const void* coords, const void* g,
                                       void* dfeat, void* dcoords, void* ints, void* partials,
                                       int B, int H, int W, int C, int N, int dtype,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? launch_bwd<bf16>(feat, coords, g, dfeat, dcoords, ints, partials, B, H, W, C, N, s)
             : launch_bwd<float>(feat, coords, g, dfeat, dcoords, ints, partials, B, H, W, C, N,
                                 s);
}

extern "C" int avr_gather_bilinear(const void* feat, const void* coords, void* out, int B,
                                   int H, int W, int C, int N, int P, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_fwd<false, bf16>(feat, coords, nullptr, out, B, H, W, C, N, P, s)
                    : launch_fwd<false, float>(feat, coords, nullptr, out, B, H, W, C, N, P, s);
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// Backward front: block (x, b) serves points [x * 8, x * 8 + 8) of view b,
// one warp each; the grid cotangent is chained through the projection to
// the world point (project_point_bwd).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_projected_bwd_kernel(const T* __restrict__ feat, const float* __restrict__ points,
                            const float* __restrict__ proj, const T* __restrict__ g,
                            float* __restrict__ dpoints, int H, int W, int C, int N) {
  __shared__ float p_s[16];
  const int b = blockIdx.y;
  if (threadIdx.x < 16) p_s[threadIdx.x] = proj[(size_t)b * 16 + threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps leave together
  const size_t pt = (size_t)b * N + n;
  const float* x = points + pt * 3;
  const Projected q = project_point(p_s, x[0], x[1], x[2]);
  const float2 dgrid = gather_point_dgrid(feat + (size_t)b * H * W * C, g + pt * C,
                                          bilinear_taps(q.gx, q.gy, H, W), q.gx, q.gy, H, W, C,
                                          lane);
  if (lane == 0) {
    const float3 d = project_point_bwd(p_s, q, dgrid);
    dpoints[pt * 3] = d.x;
    dpoints[pt * 3 + 1] = d.y;
    dpoints[pt * 3 + 2] = d.z;
  }
}

template <typename T>
static int launch_projected_bwd(const void* feat, const void* points, const void* proj,
                                const void* g, void* dfeat, void* dpoints, void* ints,
                                void* partials, int B, int H, int W, int C, int N,
                                cudaStream_t stream) {
  constexpr int warps = THREADS / 32;
  const dim3 grid((unsigned)((N + warps - 1) / warps), (unsigned)B);
  gather_projected_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)feat, (const float*)points, (const float*)proj, (const T*)g, (float*)dpoints, H,
      W, C, N);
  launch_bins<T, true>(points, proj, g, dfeat, ints, partials, B, H, W, C, N, stream);
  return (int)cudaGetLastError();
}

extern "C" int avr_gather_projected(const void* feat, const void* points, const void* proj,
                                    void* out, int B, int H, int W, int C, int N, int P,
                                    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_fwd<true, bf16>(feat, points, proj, out, B, H, W, C, N, P, s)
                    : launch_fwd<true, float>(feat, points, proj, out, B, H, W, C, N, P, s);
}

extern "C" int avr_gather_projected_bwd(const void* feat, const void* points, const void* proj,
                                        const void* g, void* dfeat, void* dpoints, void* ints,
                                        void* partials, int B, int H, int W, int C, int N,
                                        int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_projected_bwd<bf16>(feat, points, proj, g, dfeat, dpoints, ints,
                                                 partials, B, H, W, C, N, s)
                    : launch_projected_bwd<float>(feat, points, proj, g, dfeat, dpoints, ints,
                                                  partials, B, H, W, C, N, s);
}
