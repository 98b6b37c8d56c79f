// K2 dense_cache_append: in-place row writes into the dense decode KV cache.
//
// Replaces the TPU kernel `vis_zephyr_tpu/ops/kv_cache.py::_update_kernel`
// (grid (B, T) and the row index map in `dense_cache_update`). Same contract:
// the new rows k/v [B,T,Hkv,D] land at cache[layer, b, min(lengths[b]+t, S-1)]
// of ck/cv [L,Bc,S,Hkv,D], in place; padded trailing tokens are written like
// any other row (the attention mask excludes them and the next append
// overwrites them). The wrapper casts the rows to the cache dtype first, as
// the TPU wrapper does, so the kernel copies bytes and is dtype-agnostic.
//
// What bounds it on the H100: launch latency. One decode step of Zephyr-7B
// writes 2 rows of Hkv*D = 1024 bf16 (4 KB) per layer, far less HBM time than
// the launch itself takes.
//
// What the design does about it: one block per (t, b) row, each thread moving
// one 16-byte vector of k and one of v, no read-modify-write. Where the clamp
// sends several t of a row to slot S-1, only the last of them writes, so the
// result is the TPU grid's sequential "last write wins" and not a race.

#include <cuda_runtime.h>
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
