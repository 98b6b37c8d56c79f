// K1 flash_fwd: blockwise online-softmax attention forward (bf16 in/out) on
// Hopper's wgmma tensor cores, its K and V tiles brought by TMA into a ring
// in shared memory.
//
// Replaces the TPU kernel `vis_zephyr_tpu/ops/flash_attention.py::_fwd_kernel`
// (grid and block specs in `_flash_forward`). Same contract: q [B,T,Hq,D],
// k/v [B,S,Hkv,D] bf16 (the public layout, read in place by tensor maps),
// kv_valid [B,S] bool, D = 128, T and S multiples of 64; causal masking on row
// indices (col <= row) with the tiles wholly above the diagonal skipped; GQA
// (q head h reads kv head h / (Hq/Hkv)); f32 online softmax and accumulation,
// P rounded to bf16 before P.V as the TPU kernel does (`p.astype(v.dtype)`)
// while l sums the f32 probabilities; a row with no valid key writes 0, with
// l = 0 and m = NEG_INF; m (the row max of the scaled scores, natural-log
// units) and l (the sum of exp(s*scale - m)), f32 [B,Hq,T], are what K7 and K8
// recompute the probabilities from.
//
// What bounds it on the H100: operations. A causal T=S=2048 call at Hq=32 is
// 34.4 GFLOP against 42 MB of q, k, v and out, about 800 FLOP a byte, far
// above the card's 295 (bf16). The card's bf16 rate (989 TFLOP/s) comes
// only from wgmma, so both products run there, fed without register traffic.
//
// What the design does about it:
// - One block per (q head, batch row, 128-row q tile): two consumer
//   warpgroups of 64 q rows and one producer warpgroup (384 threads). The
//   producer hands its registers to the consumers (setmaxnreg: 24 and 240 a
//   thread), and its first warp issues every copy. Grid z walks the q tiles
//   from the last, so under `causal` the longest tiles of every head start
//   first.
// - Shared memory (dynamic, 225 KB): the Q tile (32 KB, loaded once) and a
//   three-stage ring of 128-key K and V tiles (32 KB each), all as TMA writes
//   them with the 128-byte swizzle that wgmma's descriptors read: a 256-byte
//   row of D = 128 is two 64-column halves. Each stage has "full" mbarriers
//   for K and for V (an expected byte count each) and "empty" ones on which
//   every consumer thread arrives when it is done with the stage's K or V,
//   so a K slot is refilled while the V beside it is still in use.
// - The tensor maps see each tensor as (column, head, row, batch): a ragged
//   last tile reads zeros at its own batch row's end, never the next row's.
// - S = Q.K^T: wgmma m64n128k16 with both operands in shared memory, 8 steps
//   over D. O += P.V: P is rounded to bf16 in registers, where the score
//   fragment is already the A fragment of the register-A wgmma m64n128k16; V
//   is the MN-major B operand (transpose bit), so no transposed copy of V is
//   made. O, 64 x 128 f32 a warpgroup, stays in registers for the row tile.
// - The two products of a warpgroup overlap its softmax (FA3's schedule):
//   S_j = Q.K_j^T and O += P_{j-1}.V_{j-1} are issued together, the softmax
//   of S_j runs while P_{j-1}.V_{j-1} is on the tensor cores, and O is
//   rescaled once that product is done.
// - The softmax runs on the accumulator fragment in registers (row max and
//   sum over a quad: two shuffles), in base 2 with scale*log2(e) folded into
//   the exponent; m goes back to natural-log units when it is stored. Masks
//   apply only on the diagonal tile and on tiles holding an invalid or
//   out-of-range key: the producer packs each tile's kv_valid into four
//   ballot words beside the stage, and interior tiles take no mask.
// - Epilogue: O / l (0 where l = 0) rounded to bf16 into the warpgroup's own
//   rows of the Q tile, swizzled, then one TMA store per half. m and l from
//   one thread of each quad.
// - T a multiple of 64 but not 128 leaves a 64-row last tile: its second
//   warpgroup has no rows and returns at once (the empty barriers count only
//   the active warpgroups' threads).
//
// Why three stages and a producer warpgroup: the forms that undo either
// (`experiments/flash_fwd_forms.py`; on 288 threads ptxas caps a thread at
// 168 registers, serializes the wgmmas and spills) are timed in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper_common.cuh"

namespace {

constexpr int kBlockM = 128;                    // q rows a block
constexpr int kBlockN = 128;                    // keys a tile
constexpr int kStages = 3;                      // K/V ring depth
constexpr int kConsumers = 256;                 // two warpgroups of 64 q rows
constexpr int kThreads = kConsumers + 128;      // + the producer warpgroup
constexpr int kQHalf = kBlockM * 128;           // bytes of one 64-column half of Q
constexpr int kKVHalf = kBlockN * 128;
constexpr int kKVBytes = 2 * kKVHalf;           // one K (or V) tile
constexpr int kOffK = 2 * kQHalf;
constexpr int kOffV = kOffK + kStages * kKVBytes;
constexpr int kOffMask = kOffV + kStages * kKVBytes;   // 4 ballot words a stage
constexpr int kOffBar = kOffMask + kStages * 16;       // q_full, then 4 barriers a stage
constexpr int kSmemBytes = kOffBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
constexpr float kNegInf = -0.7f * FLT_MAX;      // the TPU kernel's NEG_INF
constexpr float kLn2 = 0.693147180559945309f;

// S = Q K^T for one warpgroup's 64 rows against a 128-key tile: 8 steps of
// 16 over D, 4 in each 64-column half, both operands K-major in shared memory.
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_wg, uint32_t kst) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t koff = (kk % 4) * 32;   // bytes into the swizzled 128-byte row
    const uint64_t da = vzt::desc_sw128(q_wg + (kk / 4) * kQHalf + koff, 16, 1024);
    const uint64_t db = vzt::desc_sw128(kst + (kk / 4) * kKVHalf + koff, 16, 1024);
    vzt::wgmma_m64n128k16_ss(sc, da, db, kk > 0);
  }
}

// O += P V over a tile's 128 keys: 8 steps of 16 rows of V, P from registers,
// V the MN-major operand (its two 64-column halves kKVHalf apart).
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&pa)[8][4],
                                         uint32_t vst) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    vzt::wgmma_m64n128k16_rs_tb(o, pa[kk], vzt::desc_sw128(vst + kk * 16 * 128, kKVHalf, 1024),
                                1);
}

// The online-softmax step of a tile on the thread's two rows (row_a and
// row_a + 8), in base 2: masks where `mask` says (causal rule on rows, ballot
// words for kv_valid and the keys past S), turns sc into probabilities, moves
// m2 and lsum on, and returns in alpha what O must be scaled by.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], const uint32_t (&words)[4],
                                             bool mask, int causal, int kv0, int row_a, int quad,
                                             float scale_log2, float (&m2)[2], float (&lsum)[2],
                                             float (&alpha)[2]) {
  if (mask) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = kv0 + 8 * jj + 2 * quad + c;
        const bool valid = (words[jj / 4] >> (8 * (jj % 4) + 2 * quad + c)) & 1u;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!(valid && (!causal || col <= row_a + 8 * i))) sc[4 * jj + 2 * i + c] = -INFINITY;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * i], sc[4 * jj + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m2[i], mx * scale_log2);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;   // no valid key yet
    alpha[i] = vzt::ex2(m2[i] - m_use);
    m2[i] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = vzt::ex2(fmaf(sc[4 * jj + 2 * i + c], scale_log2, -m_use));
        sc[4 * jj + 2 * i + c] = p;
        rs += p;
      }
    }
    lsum[i] = lsum[i] * alpha[i] + rs;
  }
}

// P rounded to bf16: the score fragment of keys 16kk .. 16kk+15 is the A
// fragment of P.V step kk.
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = vzt::pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o,
                 const uint8_t* __restrict__ kv_valid,
                 float* __restrict__ m_out,
                 float* __restrict__ l_out,
                 int T, int S, int Hq, int Hkv, int causal, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = vzt::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzled tiles need 1024-byte alignment
  const uint32_t q_s = base;
  const uint32_t k_s = base + kOffK;
  const uint32_t v_s = base + kOffV;
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + kOffMask);
  const uint32_t q_full = base + kOffBar;
  // Stage s: K landed, V landed, K free again, V free again.
  auto full_k = [&](int s) { return base + kOffBar + 8u * (1 + s); };
  auto full_v = [&](int s) { return base + kOffBar + 8u * (1 + kStages + s); };
  auto empty_k = [&](int s) { return base + kOffBar + 8u * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return base + kOffBar + 8u * (1 + 3 * kStages + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;  // longest causal tiles first
  const int hk = h / (Hq / Hkv);
  const int n_active = min(2, (T - row0) / 64);              // warpgroups with rows
  int n_tiles = (S + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (row0 + 64 * n_active - 1) / kBlockN + 1);
  const int tid = threadIdx.x;

  if (tid == 0) {
    vzt::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      vzt::mbar_init(full_k(s), 1);
      vzt::mbar_init(full_v(s), 1);
      vzt::mbar_init(empty_k(s), 128 * n_active);
      vzt::mbar_init(empty_v(s), 128 * n_active);
    }
    vzt::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warpgroup: it gives its registers to the consumers, and its
    // first warp brings Q once, then the K/V ring. Lane 0 issues the
    // copies; the warp packs each tile's kv_valid into four ballot words.
    vzt::setmaxnreg_dec<24>();
    if (tid >= kConsumers + 32) return;
    const int lane = tid & 31;
    if (lane == 0) {
      vzt::tma_prefetch(&tm_q);
      vzt::tma_prefetch(&tm_k);
      vzt::tma_prefetch(&tm_v);
      vzt::mbar_expect_tx(q_full, 2 * kQHalf);
      vzt::tma_load_4d(q_s, &tm_q, q_full, 0, h, row0, b);
      vzt::tma_load_4d(q_s + kQHalf, &tm_q, q_full, 64, h, row0, b);
    }
    const uint8_t* valid_row = kv_valid + static_cast<long>(b) * S;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t freed = ((j / kStages) - 1) & 1;   // the phase that freed stage s
      const int kv0 = j * kBlockN;
      uint32_t words[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int col = kv0 + 32 * g + lane;
        words[g] = __ballot_sync(0xffffffffu, col < S && valid_row[col] != 0);
      }
      if (j >= kStages) vzt::mbar_wait(empty_k(s), freed);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < 4; ++g) mask_s[4 * s + g] = words[g];
        const uint32_t kd = k_s + s * kKVBytes;
        vzt::mbar_expect_tx(full_k(s), kKVBytes);
        vzt::tma_load_4d(kd, &tm_k, full_k(s), 0, hk, kv0, b);
        vzt::tma_load_4d(kd + kKVHalf, &tm_k, full_k(s), 64, hk, kv0, b);
      }
      if (j >= kStages) vzt::mbar_wait(empty_v(s), freed);
      if (lane == 0) {
        const uint32_t vd = v_s + s * kKVBytes;
        vzt::mbar_expect_tx(full_v(s), kKVBytes);
        vzt::tma_load_4d(vd, &tm_v, full_v(s), 0, hk, kv0, b);
        vzt::tma_load_4d(vd + kKVHalf, &tm_v, full_v(s), 64, hk, kv0, b);
      }
      __syncwarp();
    }
    return;
  }

  // Consumer warpgroup `wg`: q rows wrow0 .. wrow0 + 63 of the tile.
  vzt::setmaxnreg_inc<240>();
  const int wg = tid / 128;
  if (wg >= n_active) return;
  const int warp = (tid % 128) / 32;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int wrow0 = row0 + 64 * wg;
  const int row_a = wrow0 + 16 * warp + (lane >> 2);   // rows row_a and row_a + 8
  const uint32_t q_wg = q_s + wg * 64 * 128;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float sc[64];
  uint32_t pa[8][4];
  float m2[2] = {-INFINITY, -INFINITY};   // running max of s * scale * log2(e)
  float lsum[2] = {0.f, 0.f};             // this thread's part of l
  float alpha[2];

  // Reads tile j's ballot words, frees its K slot and runs its softmax. A
  // tile takes a mask only on the diagonal or with an invalid or
  // out-of-range key (a zero bit in the words).
  auto scores_to_p = [&](int j) {
    const int s = j % kStages;
    uint32_t words[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) words[g] = mask_s[4 * s + g];
    vzt::mbar_arrive(empty_k(s));
    const int kv0 = j * kBlockN;
    const bool mask = (words[0] & words[1] & words[2] & words[3]) != 0xffffffffu ||
                      (causal && kv0 + kBlockN - 1 > wrow0);
    softmax_tile(sc, words, mask, causal, kv0, row_a, quad, scale_log2, m2, lsum, alpha);
  };

  vzt::mbar_wait(q_full, 0);

  // Tile 0: S alone.
  vzt::mbar_wait(full_k(0), 0);
  vzt::wgmma_fence();
  issue_qk(sc, q_wg, k_s);
  vzt::wgmma_commit();
  vzt::wgmma_wait<0>();
  vzt::fence_regs(sc);
  scores_to_p(0);
  pack_p(sc, pa);

  // Tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} go to the tensor cores
  // together; the softmax of S_j runs while P_{j-1} V_{j-1} is in flight.
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int sp = (j - 1) % kStages;
    vzt::mbar_wait(full_k(s), (j / kStages) & 1);
    vzt::mbar_wait(full_v(sp), ((j - 1) / kStages) & 1);
    vzt::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) vzt::fence_regs(pa[kk]);
    vzt::wgmma_fence();
    issue_qk(sc, q_wg, k_s + s * kKVBytes);
    vzt::wgmma_commit();
    issue_pv(o, pa, v_s + sp * kKVBytes);
    vzt::wgmma_commit();
    vzt::wgmma_wait<1>();          // S_j is done; P_{j-1} V_{j-1} may still run
    vzt::fence_regs(sc);
    scores_to_p(j);
    vzt::wgmma_wait<0>();
    vzt::fence_regs(o);
    vzt::mbar_arrive(empty_v(sp));
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * jj + 2 * i] *= alpha[i];
        o[4 * jj + 2 * i + 1] *= alpha[i];
      }
    }
    pack_p(sc, pa);
  }

  // The last tile's P.V.
  {
    const int sl = (n_tiles - 1) % kStages;
    vzt::mbar_wait(full_v(sl), ((n_tiles - 1) / kStages) & 1);
    vzt::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) vzt::fence_regs(pa[kk]);
    vzt::wgmma_fence();
    issue_pv(o, pa, v_s + sl * kKVBytes);
    vzt::wgmma_commit();
    vzt::wgmma_wait<0>();
    vzt::fence_regs(o);
    vzt::mbar_arrive(empty_v(sl));
  }

  // Epilogue: l over the quad, O / l into this warpgroup's rows of the Q tile
  // (swizzled as TMA reads it), then one TMA store per 64-column half.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
    inv[i] = lsum[i] == 0.f ? 0.f : 1.f / lsum[i];
  }
  uint8_t* q_gen = smem_raw + (q_wg - raw);
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + (lane >> 2) + 8 * i;      // row within the warpgroup
      const int chunk = (jj % 8) ^ (r % 8);
      const uint32_t word = vzt::pack_bf16x2(o[4 * jj + 2 * i] * inv[i],
                                             o[4 * jj + 2 * i + 1] * inv[i]);
      *reinterpret_cast<uint32_t*>(q_gen + (jj / 8) * kQHalf + r * 128 + chunk * 16 +
                                   quad * 4) = word;
    }
  }
  vzt::fence_proxy_async();
  vzt::named_barrier(1 + wg, 128);
  if (tid % 128 == 0) {
    vzt::tma_store_4d(&tm_o, q_wg, 0, h, wrow0, b);
    vzt::tma_store_4d(&tm_o, q_wg + kQHalf, 64, h, wrow0, b);
    vzt::tma_store_wait_read();
  }
  if (quad == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long r = (static_cast<long>(b) * Hq + h) * T + row_a + 8 * i;
      m_out[r] = lsum[i] == 0.f ? kNegInf : m2[i] * kLn2;
      l_out[r] = lsum[i];
    }
  }
}

}  // namespace

extern "C" int vzt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* kv_valid, void* out, void* m_out,
                             void* l_out, int B, int T, int S, int Hq, int Hkv,
                             int causal, float scale, void* stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int code = vzt::make_map_bf16_bthd(&tm_q, q, B, T, Hq, kBlockM);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_k, k, B, S, Hkv, kBlockN);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_v, v, B, S, Hkv, kBlockN);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_o, out, B, T, Hq, 64);
  if (code != 0) return code;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hq, B, (T + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<const uint8_t*>(kv_valid),
      static_cast<float*>(m_out), static_cast<float*>(l_out), T, S, Hq, Hkv, causal,
      scale * 1.44269504088896341f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vzt_error_string(int code) {
  if (code >= vzt::kTensorMapErrorBase) {
    static thread_local char msg[96];
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             code - vzt::kTensorMapErrorBase);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
