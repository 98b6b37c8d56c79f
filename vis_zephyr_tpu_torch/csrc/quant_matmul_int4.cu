// K6 quant_matmul_int4: the int4 group-scaled weight-only matmul,
// out[M, N] = x[M, K] @ dequant_int4(w[N, K/2], scale4[N, G]).T in x's dtype.
//
// Replaces the TPU kernel `vis_zephyr_tpu/ops/quant_matmul.py::_make_kernel_int4`
// (wrapper `quantized_matmul_int4`). Same contract: x in bf16, each nibble
// to bf16 (exact), each group's dot summed in its own f32 accumulator, times
// that group's f32 scale (on the dot result, the TPU kernel's
// `total += d * scale`) into an f32 total, rounded once to the output type
// (bf16, or f32). Port layout: w is int8 [N, K/2], row n contiguous along K,
// two codes a byte in per-group half-split order (byte j of group g holds
// k = g*group + j in its low nibble and k = g*group + group/2 + j in its high
// nibble); scale4 is f32 [N, G]. M is 1 to 128, N and the group K / G
// multiples of 128 (the wrapper sends anything else to dequantize + matmul, as
// the JAX gate does); M is ragged: x's map reads zero rows past M.
//
// What bounds it on the H100: the weight bytes, N*K/2 of codes and 4*N*G of
// scales (3.49 GB of codes and 0.22 GB of scales a decoder pass of Zephyr-7B,
// 1.11 ms at 3.35 TB/s), up to M = 128, where the tensor work (1.81 ms a
// pass) is the larger.
//
// The design is the mainloop of `quant_matmul_common.cuh` (wgmma with the
// weights as its register A operand, a TMA ring of weights and x, split K in
// whole groups summed in order by the last block of a tile). This file is its
// int4 front end:
// - a stage is 64 bytes of each of the block's rows (128 k: half a group of
//   256, or one group of 128), TMA-swizzled by 64 bytes: chunk c of row r
//   sits at chunk c ^ ((r / 2) % 4), so a warp's eight rows hit eight bank
//   quads; its x is the two 64-wide boxes the nibbles pair with: k_lo (low
//   nibbles) and k_lo + group / 2 (high nibbles);
// - chunk c feeds two k-steps: its low nibbles step c of the low box, its high
//   nibbles step c of the high box;
// - nibble -> bf16 without I2F: one `prmt` lays the thread's bytes out as
//   [lo.b, hi.b, lo.b', hi.b'], so that the two nibbles of each A-fragment pair
//   sit 16 bits apart at one of four shifts (0, 4, 8, 12); `lop3` keeps them,
//   flips each nibble to offset binary (v + 8) and sets the bf16 exponent of
//   128 in one instruction, giving the pair (128 + v + 8); one packed bf16
//   fma subtracts 136. Exact for every code (-8 .. 7). That is 1.75
//   instructions a weight, shared loads included;
// - a group's sums stay in the wgmma accumulator; at the next group's start
//   (its first chunk already converted) the products are waited for and
//   folded into the total with the thread's two row scales, which were loaded
//   at the group's start.

#include "quant_matmul_common.cuh"

namespace vzt_qmm {

template <>
struct Front<4> {
  static constexpr int kWBox = 64;    // bytes of a row a stage: 128 k
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr int kChunks = 4;   // 16-byte chunks of a row a stage
  static constexpr int kSteps = 2;    // k-steps a chunk feeds: low and high nibbles

  // Byte offset of chunk c of row r in the stage's 64B-swizzled W tile.
  __device__ static __forceinline__ uint32_t chunk(int r, int c) {
    return static_cast<uint32_t>(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
  }
  // Stage part p of group grp, whose gq stages hold its bytes in order.
  __device__ static __forceinline__ void x_cols(int, int grp, int p, int gq, int& k_lo,
                                                int& k_hi) {
    k_lo = grp * gq * kStageK + 64 * p;
    k_hi = k_lo + 64 * gq;
  }
  __device__ static __forceinline__ int x_box(int, int q) { return q; }
  __device__ static __forceinline__ int x_step(int c) { return c; }

  // `prmt` selector giving [lo.b2h, hi.b2h, lo.b2h+1, hi.b2h+1].
  __device__ static __forceinline__ uint32_t select(int h) { return h ? 0x7362u : 0x5140u; }

  // lo0 / hi0: words t / 2 and 2 + t / 2 of row r0's chunk; lo1 / hi1 of row
  // r0 + 8. a[0] is the A fragment of the low nibbles' k-step, a[1] of the
  // high nibbles'.
  __device__ static __forceinline__ void convert(uint32_t lo0, uint32_t hi0, uint32_t lo1,
                                                 uint32_t hi1, uint32_t sel,
                                                 uint32_t (&a)[2][4]) {
    const uint32_t w0 = __byte_perm(lo0, hi0, sel);
    const uint32_t w1 = __byte_perm(lo1, hi1, sel);
    a[0][0] = pair(w0);         // row r0, k 2t, 2t + 1 (low nibbles of lo's bytes)
    a[0][1] = pair(w1);         // row r0 + 8
    a[0][2] = pair(w0 >> 8);    // row r0, k 2t + 8, 2t + 9 (low nibbles of hi's bytes)
    a[0][3] = pair(w1 >> 8);
    a[1][0] = pair(w0 >> 4);    // the same k's + group / 2: the high nibbles
    a[1][1] = pair(w1 >> 4);
    a[1][2] = pair(w0 >> 12);
    a[1][3] = pair(w1 >> 12);
  }

 private:
  // Nibbles at bits 0-3 and 16-19 of w as the bf16 pair of their signed values.
  __device__ static __forceinline__ uint32_t pair(uint32_t w) {
    uint32_t biased;   // bf16 pair 128 + (v + 8): exponent of 128, v ^ 8 in the mantissa
    asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"   // (a & b) ^ c
        : "=r"(biased) : "r"(w), "r"(0x000F000Fu), "r"(0x43084308u));
    uint32_t v;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"    // biased * 1 - 136, exact
        : "=r"(v) : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
    return v;
  }
};

}  // namespace vzt_qmm

// x bf16 [M, K], w int8 [N, K/2], scale f32 [N, G], out [M, N] (bf16, or f32
// when out_f32). K is split into `splits` ranges of `per_split` stages of 128
// k, in whole groups (every range non-empty); with splits > 1, ws is f32
// [splits, M, N] and counters int32 [N / 64], all zero (the kernel leaves them
// zero).
extern "C" int vzt_quant_matmul_int4(const void* x, const void* w, const void* scale, void* out,
                                     void* ws, void* counters, int M, int N, int K, int G,
                                     int splits, int per_split, int out_f32, void* stream) {
  const int stages = K / vzt_qmm::kStageK;
  const int gq = G > 0 && K % G == 0 ? (K / G) / vzt_qmm::kStageK : 0;
  if (M < 1 || M > vzt_qmm::kMaxM || N < 1 || N % 128 != 0 || G < 1 || K % G != 0 ||
      (K / G) % vzt_qmm::kStageK != 0 ||
      K / G < vzt_qmm::kStageK || splits < 1 || per_split < 1 || per_split % gq != 0 ||
      static_cast<long long>(splits) * per_split < stages ||
      static_cast<long long>(splits - 1) * per_split >= stages ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return vzt_qmm::run<4>(x, w, scale, out, ws, counters, M, N, K, G, gq, splits, per_split,
                         out_f32, static_cast<cudaStream_t>(stream));
}
