// K5 quant_matmul_int8: the int8 weight-only matmul,
// out[M, N] = (x[M, K] @ (w[N, K] * scale[N]).T) in x's dtype.
//
// Replaces the TPU kernel `vis_zephyr_tpu/ops/quant_matmul.py::_kernel`
// (wrapper `quantized_matmul`). Same contract, not the same blocks: x in
// bf16, int8 -> bf16 (exact), products summed in f32, times the per-column f32
// scale once on the f32 sum, rounded once to the output type (bf16 or f32).
// Port layout: w is int8 [N, K], row n contiguous along K (the layout K9, the
// Q-Former, `maybe_dequant` and the weight bridge read); scale is f32 [N]. M
// is 1 to 128 (the wrapper routes larger M to dequantize + matmul), K a
// multiple of 16 (TMA's 16-byte row stride); M, N and K % 128 are ragged: the
// tensor maps read zeros past every edge, and no output past M or N is
// written.
//
// What bounds it on the H100: the weight bytes, N * K a call (6.98 GB a
// decoder pass of Zephyr-7B, 2.08 ms at 3.35 TB/s), up to M = 128, where the
// tensor work (1.81 ms a pass) comes level with them.
//
// The design is the mainloop of `quant_matmul_common.cuh` (wgmma with the
// weights as its register A operand, a TMA ring of weights and x, split K
// summed in order by the last block of a tile). This file is its int8 front
// end:
// - a stage is 128 bytes (128 k) of each of the block's rows, TMA-swizzled by
//   128 bytes: 16-byte chunk c of row r sits at chunk c ^ (r % 8), so a warp's
//   eight rows hit eight bank quads;
// - chunk c is k-step c: its k offsets 16c .. 16c + 15, x from box c / 4 at
//   step c % 4;
// - int8 -> bf16 without I2F: the thread's four bytes (k = 2t, 2t + 1, 2t + 8,
//   2t + 9) are gathered by one `prmt`, flipped to offset binary (v + 128) by
//   one xor, each put into the low byte of the f32 2^23 (`prmt` with the
//   magic's other bytes) and 2^23 + 128 subtracted (exact for |v| <= 128),
//   and the f32 pair's high halves taken as a bf16 pair by one more `prmt`
//   (exact: an integer below 256 has 8 significant bits).

#include "quant_matmul_common.cuh"

namespace vzt_qmm {

template <>
struct Front<8> {
  static constexpr int kWBox = 128;   // bytes of a row a stage: 128 k
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr int kChunks = 8;   // 16-byte chunks of a row a stage
  static constexpr int kSteps = 1;    // k-steps of 16 a chunk feeds

  // Byte offset of chunk c of row r in the stage's 128B-swizzled W tile.
  __device__ static __forceinline__ uint32_t chunk(int r, int c) {
    return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
  }
  // Stage j's x: k = 128 j .. 128 j + 63 and 128 j + 64 .. 128 j + 127.
  __device__ static __forceinline__ void x_cols(int j, int, int, int, int& k_lo, int& k_hi) {
    k_lo = kStageK * j;
    k_hi = k_lo + 64;
  }
  __device__ static __forceinline__ int x_box(int c, int) { return c >> 2; }
  __device__ static __forceinline__ int x_step(int c) { return c & 3; }

  // `prmt` selector of bytes (2h, 2h + 1) of word lo, then of word hi.
  __device__ static __forceinline__ uint32_t select(int h) { return h ? 0x7632u : 0x5410u; }

  // lo0 / hi0: words t / 2 and 2 + t / 2 of row r0's chunk; lo1 / hi1 of row
  // r0 + 8. a[0][0..3] is the A fragment of the chunk's k-step.
  __device__ static __forceinline__ void convert(uint32_t lo0, uint32_t hi0, uint32_t lo1,
                                                 uint32_t hi1, uint32_t sel,
                                                 uint32_t (&a)[1][4]) {
    const uint32_t p0 = __byte_perm(lo0, hi0, sel) ^ 0x80808080u;
    const uint32_t p1 = __byte_perm(lo1, hi1, sel) ^ 0x80808080u;
    a[0][0] = pair(p0, 0x7650u, 0x7651u);   // row r0, k 2t, 2t + 1
    a[0][1] = pair(p1, 0x7650u, 0x7651u);   // row r0 + 8
    a[0][2] = pair(p0, 0x7652u, 0x7653u);   // row r0, k 2t + 8, 2t + 9
    a[0][3] = pair(p1, 0x7652u, 0x7653u);
  }

 private:
  // Two offset-binary bytes of p (picked by the selectors) as a bf16 pair.
  __device__ static __forceinline__ uint32_t pair(uint32_t p, uint32_t s_lo, uint32_t s_hi) {
    constexpr uint32_t kMagic = 0x4B000000u;      // 2^23: its low byte is the integer
    constexpr float kOffset = 8388736.0f;         // 2^23 + 128
    const float lo = __uint_as_float(__byte_perm(p, kMagic, s_lo)) - kOffset;
    const float hi = __uint_as_float(__byte_perm(p, kMagic, s_hi)) - kOffset;
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
  }
};

}  // namespace vzt_qmm

// x bf16 [M, K], w int8 [N, K], scale f32 [N], out [M, N] (bf16, or f32 when
// out_f32). K is split into `splits` ranges of `per_split` stages of 128
// (every range non-empty); with splits > 1, ws is f32 [splits, M, N] and
// counters int32 [ceil(N / 64)], all zero (the kernel leaves them zero).
extern "C" int vzt_quant_matmul_int8(const void* x, const void* w, const void* scale, void* out,
                                     void* ws, void* counters, int M, int N, int K, int splits,
                                     int per_split, int out_f32, void* stream) {
  const int stages = (K + vzt_qmm::kStageK - 1) / vzt_qmm::kStageK;
  if (M < 1 || M > vzt_qmm::kMaxM || K < 16 || K % 16 != 0 || N < 1 || splits < 1 ||
      per_split < 1 || static_cast<long long>(splits) * per_split < stages ||
      static_cast<long long>(splits - 1) * per_split >= stages ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return vzt_qmm::run<8>(x, w, scale, out, ws, counters, M, N, K, 1, 1, splits, per_split,
                         out_f32, static_cast<cudaStream_t>(stream));
}
