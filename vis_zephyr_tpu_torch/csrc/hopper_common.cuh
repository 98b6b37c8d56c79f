// Hopper (sm_90a) building blocks shared by the port's hand-written kernels:
// mbarriers, TMA loads and stores, wgmma shared-memory descriptors, the
// m64n128k16 and m64n64k16 bf16 products with A in shared memory, the
// m64nNk16 ones with A in registers, the mma.sync m16n8k16 bf16 product, and
// the host-side tensor-map encoders.
//
// Hand PTX through `asm volatile`; no CUTLASS or CuTe. Everything here is
// header-only and `static`/`inline`, so several sources may include it.
//
// Conventions:
// - Shared-memory addresses are 32-bit `.shared` addresses (`smem_u32`).
// - Tiles that wgmma reads are stored as TMA writes them with
//   CU_TENSOR_MAP_SWIZZLE_128B: 64 bf16 columns (128 bytes) a row, rows 128
//   bytes apart, 16-byte chunk c of row r at chunk c ^ (r % 8), every tile
//   1024-byte aligned. A 128-wide row of bf16 is two such 64-column halves.
// - wgmma accumulators are `float d[64]` in the m64nNk16 fragment: thread t of
//   the warpgroup holds rows 16 * (t / 32) + (t % 32) / 4 and that + 8,
//   columns 8 * j + 2 * (t % 4) + {0, 1}; d[4j + 2i + c] is (row + 8i, col + c).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vzt {

// ---------------------------------------------------------------------------
// Shared memory, barriers, fences.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed. A phase that never
// completes (a fault in the kernel) traps after 2^28 tries, seconds at the
// least, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t tries = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && ++tries > (1u << 28)) __trap();
  } while (!done);
}

// The same wait with its loop inside one PTX block (no C++ loop around a
// try_wait): cheaper on a hot path. It traps after 2^28 tries as well.
__device__ __forceinline__ void mbar_wait_spin(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 268435456;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// Generic-proxy writes to shared memory become visible to the async proxy
// (a TMA store or wgmma reading them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among `count` threads (a multiple of 32) under hardware id `id`
// (0 is __syncthreads').
__device__ __forceinline__ void named_barrier(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Moves a whole warpgroup's register budget down (a producer) or up (a
// consumer); the pool is the block's, so the two must balance.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// TMA.

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Copies the box at coordinates (c0, c1, c2, c3) of a 4-d map into shared
// memory at `dst`; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

// Copies the box at coordinates (c0, c1) of a 2-d map into shared memory at
// `dst`; its bytes (the whole box, zeros where it leaves the tensor) complete a
// transaction on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Copies `bytes` (a multiple of 16) of global memory at `src` (16-byte
// aligned) into shared memory at `dst`; they complete a transaction on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Copies shared memory at `src` to the box at (c0, c1, c2, c3); rows outside
// the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Commits the thread's TMA stores and waits until their shared-memory reads
// are done (the block may then exit or reuse the buffer).
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma.

// A shared-memory matrix descriptor for a 128-byte-swizzled tile (layout
// type 1). For a K-major operand `sbo` is the distance between 8-row groups
// (1024 bytes) and `lbo` is unused; for an MN-major operand `lbo` is the
// distance between 64-wide MN blocks and `sbo` between 8-deep K groups.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t desc = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  desc |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  desc |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  desc |= static_cast<uint64_t>(1) << 62;
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving register reads or writes of an operand
// across the asynchronous product's fence, commit and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define VZT_WGMMA_D64_TEXT                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                 \
  "%8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, "          \
  "%24, %25, %26, %27, %28, %29, %30, %31, "          \
  "%32, %33, %34, %35, %36, %37, %38, %39, "          \
  "%40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, "          \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

#define VZT_WGMMA_D64_OPERANDS(d)                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define VZT_WGMMA_D32_TEXT                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                 \
  "%8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, "          \
  "%24, %25, %26, %27, %28, %29, %30, %31}"

#define VZT_WGMMA_D32_OPERANDS(d)                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
  "+f"(d[30]), "+f"(d[31])

// d[64x64] (+)= A[64x16] * B[16x64], both operands K-major in shared memory
// (B stored as [N][K]); d is the m64n64k16 fragment (j = 0..7 above).
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      VZT_WGMMA_D32_TEXT ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : VZT_WGMMA_D32_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64x128] (+)= A[64x16] * B[16x128], both operands in shared memory, A
// K-major and B K-major (B stored as [N][K]). `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      VZT_WGMMA_D64_TEXT ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : VZT_WGMMA_D64_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64x128] (+)= A[64x16] * B[16x128] with A in registers (four bf16x2 words in
// the m64k16 A fragment) and B MN-major in shared memory (stored as [K][N]).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      VZT_WGMMA_D64_TEXT ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : VZT_WGMMA_D64_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#define VZT_WGMMA_D4_TEXT "{%0, %1, %2, %3}"
#define VZT_WGMMA_D4_OPERANDS(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])

#define VZT_WGMMA_D8_TEXT "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define VZT_WGMMA_D8_OPERANDS(d)                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7])

#define VZT_WGMMA_D16_TEXT                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                 \
  "%8, %9, %10, %11, %12, %13, %14, %15}"
#define VZT_WGMMA_D16_OPERANDS(d)                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
  "+f"(d[15])

// d[64xN] (+)= A[64x16] * B[16xN] with A in registers (four bf16x2 words in the
// m64k16 A fragment: thread t of the warpgroup holds rows 16 * (t / 32) +
// (t % 32) / 4 (a[0], a[2]) and that + 8 (a[1], a[3]), k = 2 * (t % 4) + {0, 1}
// (a[0], a[1]) and that + 8 (a[2], a[3])) and B K-major in shared memory
// (stored as [N][K]); d is the m64nNk16 fragment, N / 2 floats. N is 8, 16,
// 32, 64 or 128. `accumulate` 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate);

// A0..A3, B and P are the operand numbers of a[0..3], desc_b and accumulate.
#define VZT_WGMMA_RS(N, DTEXT, DOPS, A0, A1, A2, A3, B, P)                            \
  template <>                                                                          \
  __device__ __forceinline__ void wgmma_m64k16_rs<N>(float (&d)[N / 2],               \
                                                      const uint32_t (&a)[4],          \
                                                      uint64_t desc_b, int accumulate) { \
    asm volatile(                                                                      \
        "{\n"                                                                          \
        ".reg .pred p;\n"                                                              \
        "setp.ne.b32 p, %" P ", 0;\n"                                                  \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " DTEXT             \
        ", {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" B ", p, 1, 1, 0;\n"                 \
        "}\n"                                                                          \
        : DOPS(d)                                                                      \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));   \
  }

VZT_WGMMA_RS(8, VZT_WGMMA_D4_TEXT, VZT_WGMMA_D4_OPERANDS, "4", "5", "6", "7", "8", "9")
VZT_WGMMA_RS(16, VZT_WGMMA_D8_TEXT, VZT_WGMMA_D8_OPERANDS, "8", "9", "10", "11", "12", "13")
VZT_WGMMA_RS(32, VZT_WGMMA_D16_TEXT, VZT_WGMMA_D16_OPERANDS, "16", "17", "18", "19", "20", "21")
VZT_WGMMA_RS(64, VZT_WGMMA_D32_TEXT, VZT_WGMMA_D32_OPERANDS, "32", "33", "34", "35", "36", "37")
VZT_WGMMA_RS(128, VZT_WGMMA_D64_TEXT, VZT_WGMMA_D64_OPERANDS, "64", "65", "66", "67", "68",
             "69")
#undef VZT_WGMMA_RS

// ---------------------------------------------------------------------------
// mma.sync.

// d (+)= a * b on mma.sync m16n8k16, bf16 operands and f32 sums. With g =
// lane / 4 and t = lane % 4: a is the 16x16 A fragment (a0 row g, k 2t and
// 2t + 1; a1 row g + 8; a2, a3 the same rows at k + 8), b the 16x8 B fragment
// (b0 k 2t and 2t + 1 of column g; b1 at k + 8), d the 16x8 C fragment (d0,
// d1 row g, columns 2t and 2t + 1; d2, d3 row g + 8).
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint32_t b0,
                                                  uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Math.

// 2^x on the special-function unit (exact 0 for -inf).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, encoded by `cuTensorMapEncodeTiled` as the CUDA
// runtime's entry-point lookup hands it out (no -lcuda).

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Codes above this are a CUresult of cuTensorMapEncodeTiled plus the offset,
// not a cudaError_t.
constexpr int kTensorMapErrorBase = 100000;

static inline cudaError_t encode_tiled_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &status);
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || ptr == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// A map over a contiguous bf16 tensor [batch, rows, heads, 128] seen as the
// 4-d (column, head, row, batch), boxes of 64 columns x 1 head x `box_rows`
// rows x 1 batch, 128-byte swizzled. Rows past `rows` read as zeros and are
// not written, so a ragged last tile never touches the next batch row.
// Returns 0 or an error code (kTensorMapErrorBase + CUresult for a refusal).
static inline int make_map_bf16_bthd(CUtensorMap* map, const void* base, int batch, int rows,
                                     int heads, int box_rows) {
  EncodeTiledFn encode;
  cudaError_t err = encode_tiled_fn(&encode);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cuuint64_t dims[4] = {128, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(heads) * 128 * 2;
  const cuuint64_t strides[3] = {128 * 2, row_bytes, row_bytes * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapErrorBase + static_cast<int>(res);
}

// A map over a row-major 2-d tensor [rows, cols] of `dtype` (`elem_bytes` a
// value, rows `row_bytes` apart, a multiple of 16), boxes of `box_cols` x
// `box_rows` with the given swizzle. Reads past the tensor's edge fill zeros.
// Returns 0 or an error code (kTensorMapErrorBase + CUresult for a refusal).
static inline int make_map_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* base,
                              int rows, int cols, long long row_bytes, int box_cols,
                              int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode;
  cudaError_t err = encode_tiled_fn(&encode);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUresult res = encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapErrorBase + static_cast<int>(res);
}

}  // namespace vzt
