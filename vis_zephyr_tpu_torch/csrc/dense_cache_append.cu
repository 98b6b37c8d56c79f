// K2 dense_cache_append: in-place row writes into the dense decode KV cache.
//
// Replaces the TPU kernel `vis_zephyr_tpu/ops/kv_cache.py::_update_kernel`
// (grid (B, T) and the row index map in `dense_cache_update`). Same contract:
// the new rows k/v [B,T,Hkv,D] land at cache[layer, b, min(lengths[b]+t, S-1)]
// of ck/cv [L,Bc,S,Hkv,D], in place; padded trailing tokens are written like
// any other row (the attention mask excludes them and the next append
// overwrites them). Two entries:
// - `vzt_dense_cache_append`, the TPU kernel's contract (rows already
//   rotated): the wrapper casts the rows to the cache dtype first, as the
//   TPU wrapper does, and the kernel copies bytes;
// - `vzt_dense_cache_append_rope`, what the decoder's dense-cache forward
//   calls once a layer: k arrives BEFORE its rotate-half RoPE, with the
//   forward's cos/sin tables [B,T,D/2] f32, rows and cache in the model's
//   dtype (bf16 or f32); the kernel rotates k as it writes. The JAX package
//   rotates k outside its kernel; on this card the append is a launch's
//   floor and the rotation about nine eager launches more a layer, whose
//   only reader is the cache. The arithmetic repeats eager PyTorch's
//   `apply_rope` bit for bit: cos and sin rounded to the row dtype, each of
//   the four products rounded to it, the difference and the sum rounded to
//   it; explicit `_rn` intrinsics keep nvcc from contracting a product into
//   an fma.
//
// What bounds it on the H100: launch latency. One decode step of Zephyr-7B
// writes 2 rows of Hkv*D = 1024 bf16 (4 KB) per layer, far less HBM time than
// the launch itself takes.
//
// What the design does about it: one block per (t, b) row, no
// read-modify-write, and the rotation folded into the same launch. Where the
// clamp sends several t of a row to slot S-1, only the last of them writes,
// so the result is the TPU grid's sequential "last write wins" and not a race.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__global__ void dense_cache_append_kernel(uint4* __restrict__ ck, uint4* __restrict__ cv,
                                          const uint4* __restrict__ k,
                                          const uint4* __restrict__ v,
                                          const int32_t* __restrict__ lengths, int layer,
                                          int Bc, int T, int S, int row_vecs) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int want = lengths[b] + t;
  if (want >= S - 1 && t != T - 1) return;  // a later t owns the clamped slot
  const int slot = min(want, S - 1);
  const long dst = (((long)layer * Bc + b) * S + slot) * row_vecs;
  const long src = ((long)b * T + t) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) {
    ck[dst + i] = k[src + i];
    cv[dst + i] = v[src + i];
  }
}

// A value of type X as float, and a float rounded to X (round to nearest even).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename X> __device__ __forceinline__ X narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to X, as float.
template <typename X> __device__ __forceinline__ float rounded(float x) {
  return widen(narrow<X>(x));
}

// Row (t, b): element pair (h, d < D/2) of k rotated by (cos, sin)[b, t, d]:
// out[d] = x1 c - x2 s, out[d + D/2] = x2 c + x1 s, every step rounded to the
// row and cache type R; v copied.
template <typename R>
__global__ void dense_cache_append_rope_kernel(R* __restrict__ ck, R* __restrict__ cv,
                                               const R* __restrict__ k,
                                               const R* __restrict__ v,
                                               const float* __restrict__ cos_t,
                                               const float* __restrict__ sin_t,
                                               const int32_t* __restrict__ lengths, int layer,
                                               int Bc, int T, int S, int Hkv, int D) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int want = lengths[b] + t;
  // A later t owns the clamped slot. Only the stores wait on `lengths`: the
  // rows' loads and arithmetic go ahead of it.
  const bool mine = want < S - 1 || t == T - 1;
  const int slot = min(want, S - 1);
  const int half = D / 2;
  const long row = (long)Hkv * D;
  const long dst = (((long)layer * Bc + b) * S + slot) * row;
  const long src = ((long)b * T + t) * row;
  const long table = ((long)b * T + t) * half;
  for (int i = threadIdx.x; i < Hkv * half; i += blockDim.x) {
    const int h = i / half, d = i % half;
    const float c = rounded<R>(cos_t[table + d]);
    const float s = rounded<R>(sin_t[table + d]);
    const long lo = src + (long)h * D + d;
    const float x1 = widen(k[lo]), x2 = widen(k[lo + half]);
    const float a = rounded<R>(__fmul_rn(x1, c)), bs = rounded<R>(__fmul_rn(x2, s));
    const float e = rounded<R>(__fmul_rn(x2, c)), f = rounded<R>(__fmul_rn(x1, s));
    const R v1 = v[lo], v2 = v[lo + half];
    if (mine) {
      const long out = dst + (long)h * D + d;
      ck[out] = narrow<R>(__fsub_rn(a, bs));
      ck[out + half] = narrow<R>(__fadd_rn(e, f));
      cv[out] = v1;
      cv[out + half] = v2;
    }
  }
}

template <typename R>
void launch_rope(void* ck, void* cv, const void* k, const void* v, const void* cos,
                 const void* sin, const void* lengths, int layer, int Bc, int B, int T, int S,
                 int Hkv, int D, cudaStream_t stream) {
  const int work = Hkv * D / 2;
  const int threads = work < 512 ? (work + 31) / 32 * 32 : 512;
  dense_cache_append_rope_kernel<R><<<dim3(T, B), threads, 0, stream>>>(
      static_cast<R*>(ck), static_cast<R*>(cv), static_cast<const R*>(k),
      static_cast<const R*>(v), static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<const int32_t*>(lengths), layer, Bc, T, S, Hkv, D);
}

}  // namespace

extern "C" int vzt_dense_cache_append(void* ck, void* cv, const void* k, const void* v,
                                      const void* lengths, int layer, int Bc, int B,
                                      int T, int S, int row_bytes, void* stream) {
  const int row_vecs = row_bytes / 16;
  const int threads = row_vecs < 256 ? row_vecs : 256;
  const dim3 grid(T, B);
  dense_cache_append_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(ck), static_cast<uint4*>(cv), static_cast<const uint4*>(k),
      static_cast<const uint4*>(v), static_cast<const int32_t*>(lengths), layer, Bc, T, S,
      row_vecs);
  return static_cast<int>(cudaGetLastError());
}

// k before RoPE and v [B, T, Hkv, D], ck and cv [L, Bc, S, Hkv, D], all f32
// when f32, else bf16; cos, sin [B, T, D/2] f32.
extern "C" int vzt_dense_cache_append_rope(void* ck, void* cv, const void* k, const void* v,
                                           const void* cos, const void* sin,
                                           const void* lengths, int layer, int Bc, int B, int T,
                                           int S, int Hkv, int D, int f32, void* stream) {
  if (T == 0 || B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    launch_rope<float>(ck, cv, k, v, cos, sin, lengths, layer, Bc, B, T, S, Hkv, D, s);
  } else {
    launch_rope<__nv_bfloat16>(ck, cv, k, v, cos, sin, lengths, layer, Bc, B, T, S, Hkv, D, s);
  }
  return static_cast<int>(cudaGetLastError());
}
