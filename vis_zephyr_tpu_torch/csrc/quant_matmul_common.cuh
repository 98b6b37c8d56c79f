// The mainloop K5 (`quant_matmul_int8.cu`) and K6 (`quant_matmul_int4.cu`)
// share: a weight-only matmul out[M, N] = x[M, K] @ dequant(w).T for
// 1 <= M <= 128, computed as its transpose outT[N, M] = W[N, K] . xT on
// Hopper's wgmma tensor cores, the weights converted to bf16 in registers.
// Each source supplies its front end (`Front<8>` or `Front<4>`): how a stage
// of weight bytes is laid out, how a thread turns its bytes into A fragments,
// and which x a stage pairs with.
//
// What bounds both on the H100: the weight bytes (a decoder pass of
// Zephyr-7B reads 6.98 GB of int8 or 3.71 GB of int4 codes and scales, 2.1 and
// 1.1 ms at 3.35 TB/s), up to M = 128, where the bf16 tensor work (1.8 ms a
// pass) comes level with them. The conversion to bf16 costs CUDA-core work
// on every weight, whatever M is, so it is done once per weight and feeds every
// row of x.
//
// The design:
// - Swap A and B. The weight tile is wgmma's 64-row A operand, taken from
//   registers (`vzt::wgmma_m64k16_rs`); x is the B operand, K-major in shared
//   memory, its rows padded to n = 8, 16, 32, 64 or 128 (M rounded up; the
//   padding rows read as zeros). One weight fragment serves every row of x.
// - A ring of stages, each 128 of K: the block's W rows (a TMA box of int8
//   bytes, 128-byte swizzled for int8 rows of 128 bytes, 64-byte swizzled for
//   int4 rows of 64) and two 64-wide boxes of x (bf16, 128-byte swizzled as
//   wgmma reads them). The ring holds 4 to 8 stages, as many as fit in 64 KB.
//   A producer warp issues a stage's three copies on its "full" mbarrier and
//   refills a slot once every consumer thread has arrived on its "empty" one.
//   Beside two consumer warpgroups it makes a block of 288 threads, which
//   ptxas holds to 168 registers (int4 at n = 128 spills a little there; a
//   form without the producer warp was slower everywhere else). x is read
//   from L2 by every block that needs it; the weights from HBM once.
// - One warpgroup of 64 W rows (n <= 32) or two (n >= 64, so that a stage of x
//   serves 128 W rows). Thread (warp w, lane 4g + t) reads, for each 16-byte
//   chunk of its two rows 16w + g and 16w + g + 8, the 32-bit words t / 2 and
//   2 + t / 2 (two shared loads, conflict-free under either swizzle), keeps
//   their halves t % 2 (one `prmt`) and converts them: those are exactly the
//   bytes of k = 2t, 2t + 1, 2t + 8, 2t + 9 that the A fragment wants, so x
//   keeps its own order. No permutation of K anywhere.
// - Each 16-byte chunk is a wgmma group of its own (one k-step for int8, two
//   for int4), committed as soon as it is converted, so the next chunk is
//   converted while its products run (one group a stage measures the same:
//   `experiments/quant_matmul_forms.py`); the warpgroup waits for them once
//   a stage, and only then converts the next stage. The forms that converted
//   stage i + 1 into a second set of fragments beside stage i's products,
//   for the overlap, made ptxas serialize every wgmma of the kernel (C7513:
//   a WARPGROUP.DEPBAR after each HGMMA), and waiting chunk by chunk for the
//   stage before instead was slower (PERF.md, PR 12).
// - Narrow N (k/v at N = 1024 has 16 tiles of 64 rows) is split over K across
//   blocks (gridDim.y), in whole groups for int4. Each split writes its f32
//   accumulator fragments; the last block of a column tile to finish (an
//   atomic count per tile) adds the tile's fragments in split order, scales,
//   rounds and writes, then resets the count. The sum's order never depends
//   on which block came last.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace vzt_qmm {

constexpr int kStageK = 128;        // k per ring stage
constexpr int kRingBytes = 65536;   // the ring holds as many stages as fit, 4 to 8
constexpr int kMaxM = 128;

template <int BITS>
struct Front;

// Tile shape by the bits of a weight and n, the rows of x rounded up.
template <int BITS, int NR>
struct Shape {
  static constexpr int kWG = NR >= 64 ? 2 : 1;          // consumer warpgroups
  static constexpr int kBlockN = 64 * kWG;              // W rows (output columns) a block
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;      // + the producer warp
  static constexpr int kMinBlocks = kWG == 1 ? 3 : 1;   // blocks an SM holds at once
  static constexpr int kXBox = NR * 128;                // bytes of one 64-wide box of x
  static constexpr int kStageBytes = 2 * kXBox + kBlockN * Front<BITS>::kWBox;
  static constexpr int kStages = kRingBytes / kStageBytes < 4   ? 4
                                 : kRingBytes / kStageBytes > 8 ? 8
                                                                : kRingBytes / kStageBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + 16 * kStages + 1024;  // + slack
};

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_f32) {
  if (out_f32) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  }
}

// One block: W rows [blockIdx.x * kBlockN, +kBlockN) over the stages
// [blockIdx.y * per_groups * gq, +per_groups * gq) of K: whole groups of gq
// stages (int4; a group is a stage for int8). `ws` and `counters` are used
// when gridDim.y > 1.
template <int BITS, int NR>
__global__ void __launch_bounds__(Shape<BITS, NR>::kThreads, Shape<BITS, NR>::kMinBlocks)
    qmm_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ scale, void* __restrict__ out, float* __restrict__ ws,
               int* __restrict__ counters, int M, int N, int G, int gq, int stages,
               int per_groups, int out_f32) {
  using S = Shape<BITS, NR>;
  using F = Front<BITS>;
  constexpr int kStages = S::kStages;
  constexpr int kStageBytes = S::kStageBytes;

  extern __shared__ uint8_t smem_raw[];
  __shared__ int last_block;
  const uint32_t raw = vzt::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles need 1024-byte alignment
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int j0 = split * per_groups * gq;         // splits start on a group's first stage
  const int count = min(stages - j0, per_groups * gq);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      vzt::mbar_init(full(s), 1);
      vzt::mbar_init(empty(s), S::kConsumers);
    }
    vzt::fence_barrier_init();
    vzt::tma_prefetch(&tm_x);
    vzt::tma_prefetch(&tm_w);
  }
  __syncthreads();

  const int lane = tid & 31;
  if (__shfl_sync(0xffffffffu, tid, 0) >= S::kConsumers) {   // uniform, as the compiler sees it
    // The producer warp (it runs no wgmma, so its waits may trap): lane 0
    // refills each slot as soon as its consumers free it. Stage i (global
    // stage j0 + i), part p of group grp's gq stages, goes into slot
    // i % kStages.
    int grp = split * per_groups, p = 0;
    for (int i = 0; i < count; ++i) {
      const int s = i % kStages;
      if (i >= kStages) vzt::mbar_wait(empty(s), ((i / kStages) - 1) & 1);
      if (lane == 0) {
        const uint32_t st = base + s * kStageBytes;
        int k_lo, k_hi;
        F::x_cols(j0 + i, grp, p, gq, k_lo, k_hi);
        vzt::mbar_expect_tx(full(s), kStageBytes);
        vzt::tma_load_2d(st, &tm_x, full(s), k_lo, 0);
        vzt::tma_load_2d(st + S::kXBox, &tm_x, full(s), k_hi, 0);
        vzt::tma_load_2d(st + 2 * S::kXBox, &tm_w, full(s), (j0 + i) * F::kWBox,
                         tile * S::kBlockN);
      }
      __syncwarp();
      if (++p == gq) {
        p = 0;
        ++grp;
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);   // this thread's W rows: r0 and r0 + 8
  const int n0 = tile * S::kBlockN + r0;
  const uint32_t sel = F::select(t & 1);
  const uint32_t o0 = F::chunk(r0, 0) + 4u * (t >> 1);   // chunk c: o0 ^ (c << 4), likewise o1
  const uint32_t o1 = F::chunk(r0 + 8, 0) + 4u * (t >> 1);

  float acc[NR / 2];
  float total[BITS == 4 ? NR / 2 : 1];
#pragma unroll
  for (int e = 0; e < NR / 2; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < (BITS == 4 ? NR / 2 : 1); ++e) total[e] = 0.f;
  uint32_t a[F::kChunks][F::kSteps][4];   // the A fragments of a stage's chunks
  float sc[2] = {0.f, 0.f};   // int4: the current group's scales of rows r0, r0 + 8
  int grp = split * per_groups, part = 0;   // int4: the stage's group, and which of its stages

  for (int i = 0; i < count; ++i) {
    const int s = i % kStages;
    const uint32_t st = base + s * kStageBytes;
    const uint8_t* wt = smem_raw + (st - raw) + 2 * S::kXBox;
    vzt::mbar_wait_spin(full(s), (i / kStages) & 1);
    // Chunk by chunk, each chunk a wgmma group of its own: convert, fence,
    // issue, commit; the next chunk is converted while this one's products
    // run. The accumulator is not touched while products run. The x
    // descriptors are computed from uniform values where they are used, so
    // that ptxas keeps them in uniform registers. Every product accumulates
    // (acc starts at zero, and int4 zeroes it at a group's start).
#pragma unroll
    for (int c = 0; c < F::kChunks; ++c) {
      const uint8_t* w0 = wt + (o0 ^ (c << 4));
      const uint8_t* w1 = wt + (o1 ^ (c << 4));
      F::convert(*reinterpret_cast<const uint32_t*>(w0), *reinterpret_cast<const uint32_t*>(w0 + 8),
                 *reinterpret_cast<const uint32_t*>(w1), *reinterpret_cast<const uint32_t*>(w1 + 8),
                 sel, a[c]);
      if constexpr (BITS == 4) {
        if (c == 0 && part == 0) {
          // A new group (the last one's products are done): the last one's
          // sums scaled into the total, sums from zero, this one's scales.
          if (i > 0) {
            vzt::wgmma_wait<0>();
            vzt::fence_regs(acc);
#pragma unroll
            for (int e = 0; e < NR / 2; ++e) {
              total[e] += acc[e] * sc[(e >> 1) & 1];
              acc[e] = 0.f;
            }
          }
          sc[0] = __ldg(scale + static_cast<size_t>(n0) * G + grp);
          sc[1] = __ldg(scale + static_cast<size_t>(n0 + 8) * G + grp);
        }
      }
#pragma unroll
      for (int q = 0; q < F::kSteps; ++q) vzt::fence_regs(a[c][q]);
      vzt::wgmma_fence();
#pragma unroll
      for (int q = 0; q < F::kSteps; ++q)
        vzt::wgmma_m64k16_rs<NR>(
            acc, a[c][q],
            vzt::desc_sw128(st + F::x_box(c, q) * S::kXBox + 32u * F::x_step(c), 16, 1024), 1);
      vzt::wgmma_commit();
    }
    if constexpr (BITS == 4) {
      if (++part == gq) {
        part = 0;
        ++grp;
      }
    }
    // The stage's products done, its slot is free for the producer (stage
    // i + 1 is converted after them: see the note at the top).
    vzt::wgmma_wait<0>();
    vzt::mbar_arrive(empty(s));
  }
  vzt::wgmma_wait<0>();
  vzt::fence_regs(acc);
  if constexpr (BITS == 4) {
#pragma unroll
    for (int e = 0; e < NR / 2; ++e) acc[e] = total[e] + acc[e] * sc[(e >> 1) & 1];
  }

  if (gridDim.y > 1) {
    // Split K: the fragments go to ws, fragment-major ([split][tile][the
    // fragment's float4 v][thread], so that a warp's float4 stores and loads
    // are contiguous); the last block of the tile to arrive adds the splits'
    // in split order.
    constexpr int kVecs = NR / 8;   // float4s of a thread's fragment
    const size_t tile_vecs = static_cast<size_t>(kVecs) * S::kConsumers;
    float4* mine = reinterpret_cast<float4*>(ws) + (static_cast<size_t>(split) * gridDim.x + tile) *
                                                       tile_vecs + tid;
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      __stcg(mine + v * S::kConsumers,
             make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]));
    __threadfence();
    vzt::named_barrier(1, S::kConsumers);
    if (tid == 0) last_block = atomicAdd(counters + tile, 1) == static_cast<int>(gridDim.y) - 1;
    vzt::named_barrier(1, S::kConsumers);
    if (!last_block) return;
    __threadfence();
#pragma unroll
    for (int e = 0; e < NR / 2; ++e) acc[e] = 0.f;
    for (int p = 0; p < static_cast<int>(gridDim.y); ++p) {
      const float4* part = reinterpret_cast<const float4*>(ws) +
                           (static_cast<size_t>(p) * gridDim.x + tile) * tile_vecs + tid;
      float4 got[kVecs];
#pragma unroll
      for (int v = 0; v < kVecs; ++v) got[v] = __ldcg(part + v * S::kConsumers);
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        acc[4 * v] += got[v].x;
        acc[4 * v + 1] += got[v].y;
        acc[4 * v + 2] += got[v].z;
        acc[4 * v + 3] += got[v].w;
      }
    }
    if (tid == 0) counters[tile] = 0;
  }

  // The thread's outputs: acc[4jj + 2h + cc] is W row r0 + 8h (column n of
  // out) and x row 8jj + 2t + cc (row m of out); int8 scales the column.
  float colscale[2] = {1.f, 1.f};
  if constexpr (BITS == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) colscale[h] = n0 + 8 * h < N ? __ldg(scale + n0 + 8 * h) : 0.f;
  }
#pragma unroll
  for (int jj = 0; jj < NR / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int m = 8 * jj + 2 * t + cc;
        const int n = n0 + 8 * h;
        if (m < M && n < N)
          store_out(out, static_cast<size_t>(m) * N + n, acc[4 * jj + 2 * h + cc] * colscale[h],
                    out_f32);
      }
}

// Launches one instantiation on a grid of (tiles, splits).
template <int BITS, int NR>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const void* scale, void* out,
                   void* ws, void* counters, int M, int N, int G, int gq, int stages,
                   int splits, int per_groups, int out_f32, cudaStream_t stream) {
  using S = Shape<BITS, NR>;
  cudaError_t err = cudaFuncSetAttribute(qmm_kernel<BITS, NR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + S::kBlockN - 1) / S::kBlockN, splits);
  qmm_kernel<BITS, NR><<<grid, S::kThreads, S::kSmemBytes, stream>>>(
      tm_x, tm_w, static_cast<const float*>(scale), out, static_cast<float*>(ws),
      static_cast<int*>(counters), M, N, G, gq, stages, per_groups, out_f32);
  return cudaGetLastError();
}

// x bf16 [M, K] seen by TMA in 64-wide boxes of n rows; w int8 bytes
// [N, w_row_bytes] in boxes of kWBox bytes x kBlockN rows. Picks n from M.
template <int BITS>
int run(const void* x, const void* w, const void* scale, void* out, void* ws, void* counters,
        int M, int N, int K, int G, int gq, int splits, int per_split, int out_f32,
        cudaStream_t stream) {
  const int stages = (K + kStageK - 1) / kStageK;
  const int w_row_bytes = BITS == 8 ? K : K / 2;
  int n = 8;
  while (n < M) n *= 2;
  const int block_n = n >= 64 ? 128 : 64;
  CUtensorMap tm_x, tm_w;
  int code = vzt::make_map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2LL * K, 64, n,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (code == 0)
    code = vzt::make_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, w_row_bytes, w_row_bytes,
                            Front<BITS>::kWBox, block_n, Front<BITS>::kSwizzle);
  if (code != 0) return code;
  cudaError_t err;
#define VZT_QMM_CASE(NR)                                                                    \
  err = launch<BITS, NR>(tm_x, tm_w, scale, out, ws, counters, M, N, G, gq, stages, splits, \
                         per_split / gq, out_f32, stream)
  if (n == 8) {
    VZT_QMM_CASE(8);
  } else if (n == 16) {
    VZT_QMM_CASE(16);
  } else if (n == 32) {
    VZT_QMM_CASE(32);
  } else if (n == 64) {
    VZT_QMM_CASE(64);
  } else {
    VZT_QMM_CASE(128);
  }
#undef VZT_QMM_CASE
  return static_cast<int>(err);
}

}  // namespace vzt_qmm
