// Hopper (sm_90a) building blocks shared by the redesigned K2 kernels (the
// bf16 forward and backward; the float32 forward's bulk copies): TMA tensor
// maps (encoded on the host by cuTensorMapEncodeTiled, whose address the
// CUDA runtime hands out, so the library needs no -lcuda), mbarrier rings,
// TMA loads and stores, and the warpgroup matrix multiply (wgmma) with
// shared-memory descriptors for 128-byte-swizzled tiles.
//
// Tile layout.  Every tile here is what a TMA box of {64 bf16 (128 bytes),
// rows} writes with CU_TENSOR_MAP_SWIZZLE_128B: rows 128 bytes apart, the
// 16-byte group g of row r stored at group g ^ (r % 8), each box 1024-byte
// aligned.  A wgmma operand reads such boxes through a descriptor:
//   K-major (the contraction dim is the box's 64-wide inner dim): 8-row
//     groups 1024 bytes apart (SBO); a k16 step adds 32 bytes to the start.
//   MN-major (the inner dim is M or N, the rows are the contraction): 64-wide
//     MN chunks LBO bytes apart (one box each), 8-row groups 1024 apart
//     (SBO); a k16 step adds 16 rows (2,048 bytes) to the start.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

static PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A bf16 tensor map of rank 2 or 3: dims innermost first, strides in bytes
// of dims 1.. (multiples of 16), box innermost first (box[0] = 64: one
// 128-byte swizzle row).  Elements outside dims read as zero; a store
// skips them.  Returns 0 or a cudaError_t.
static int make_tensor_map(CUtensorMap* m, const void* base, int rank, const uint64_t* dims,
                           const uint64_t* strides, const uint32_t* box) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = tensor_map_encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const uint32_t ones[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                         const_cast<void*>(base), (const cuuint64_t*)dims,
                         (const cuuint64_t*)strides, (const cuuint32_t*)box,
                         (const cuuint32_t*)ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// (rows x cols) row-major bf16 with row stride ld elements, boxes of
// {64, box_rows}.
static int map_2d(CUtensorMap* m, const void* base, uint64_t rows, uint64_t cols, uint64_t ld,
                  uint32_t box_rows) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {ld * 2};
  const uint32_t box[2] = {64, box_rows};
  return make_tensor_map(m, base, 2, dims, strides, box);
}

// (n x rows x cols) contiguous bf16, boxes of {64, box_rows, 1}.
static int map_3d(CUtensorMap* m, const void* base, uint64_t n, uint64_t rows, uint64_t cols,
                  uint32_t box_rows) {
  const uint64_t dims[3] = {cols, rows, n}, strides[2] = {cols * 2, rows * cols * 2};
  const uint32_t box[3] = {64, box_rows, 1};
  return make_tensor_map(m, base, 3, dims, strides, box);
}

// ---------------------------------------------------------------------------
// device: barriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// Wait until the barrier's phase with the given parity has completed.  A
// wait of more than ~2^34 cycles (seconds) can only be a fault in the
// pipeline's bookkeeping: it traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by one bulk copy, completing on the barrier's tx count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"((uint64_t)map), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The committed stores have read their shared memory (it may be rewritten).
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory made visible to the async proxy
// (TMA stores, wgmma operand reads).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand.
__device__ __forceinline__ uint64_t gmma_desc(const void* start, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(start);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x 128 float32, the warpgroup's accumulator fragment) (+)= A (64 x
// 16) B (16 x 128), bf16 operands from shared memory.  TA / TB: 0 K-major,
// 1 MN-major.  accumulate = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// Fragment position of accumulator register i for thread t of the
// warpgroup: row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// Byte offset of element (row, col) in a run of swizzled {64, rows} boxes
// laid side by side (box b = col / 64 at b * box_bytes).
__device__ __forceinline__ uint32_t swz_off(int row, int col, uint32_t box_bytes) {
  return (uint32_t)(col >> 6) * box_bytes + (uint32_t)row * 128u +
         ((uint32_t)(((col >> 3) & 7) ^ (row & 7)) << 4) + (uint32_t)(col & 7) * 2u;
}
