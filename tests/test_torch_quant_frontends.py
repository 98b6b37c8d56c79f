"""K5's and K6's weight paths and schedule, held on the CPU.

The kernels (`vis_zephyr_tpu_torch/csrc/quant_matmul_{int8,int4}.cu` on
`quant_matmul_common.cuh`) run only on the card. What they do to the bits
is mirrored here in numpy, step for step as the header notes say:

- the int8 conversion (xor to offset binary, the byte into the f32 2^23, minus
  2^23 + 128, the high half as bf16) on all 256 codes, and the int4
  conversion (`prmt` layout, `lop3` into the bf16 128 + v + 8, a packed bf16
  fma of -136) on all 16 x 16 nibble pairs, each exactly equal to the JAX
  package's dequantization;
- a whole stage: W bytes laid out as TMA's 128- or 64-byte swizzle writes
  them, every consumer thread's shared-memory words, `prmt` selectors and
  A fragments, placed by the wgmma fragment layout at the k that the x boxes
  give them: the stage's dequantized W tile, exactly, for int8, int4 at
  group 128 and int4 at group 256;
- `quant_matmul.schedule`: at every decoder and Q-Former shape and
  M = 1, 7, 32, 128, each (column tile, K range) once, in whole groups for
  int4, summed in split order; and the schedule's arithmetic at small
  shapes against the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from vis_zephyr_tpu.ops import quant as jquant
from vis_zephyr_tpu_torch.ops import quant as tquant
from vis_zephyr_tpu_torch.ops import quant_matmul as tqmm

# (K, N) of every quantized projection: the decoder's q/o, k/v, gate/up and
# down, the Q-Former's packed in_proj, cross k/v (and q / out_proj), ffn.0, ffn.2.
SHAPES = {"decoder q, o": (4096, 4096), "decoder k, v": (4096, 1024),
          "decoder gate, up": (4096, 14336), "decoder down": (14336, 4096),
          "Q-Former in_proj": (4096, 12288), "Q-Former cross k, v": (5120, 4096),
          "Q-Former ffn.0": (4096, 8192), "Q-Former ffn.2": (8192, 4096)}
ROWS = (1, 7, 32, 128)
H100_SMS = 132


# -- the bit-level mirrors --------------------------------------------------------------


def byte_perm(x, y, sel):
    """CUDA's `__byte_perm` (`prmt`): byte i of the result is byte
    (sel >> 4i) & 7 of y:x (elementwise; sel may vary per element)."""
    x, y, sel = np.broadcast_arrays(np.asarray(x, np.uint32), np.asarray(y, np.uint32),
                                    np.asarray(sel, np.uint32))
    src = np.stack([(v >> np.uint32(8 * i)) & np.uint32(0xFF) for v in (x, y) for i in range(4)],
                   axis=-1)
    out = np.zeros(x.shape, np.uint32)
    for i in range(4):
        idx = ((sel >> np.uint32(4 * i)) & np.uint32(7)).astype(np.int64)[..., None]
        out |= np.take_along_axis(src, idx, axis=-1)[..., 0] << np.uint32(8 * i)
    return out


def bf16_pair(words):
    """uint32 words → float32 [..., 2]: the bf16 in the low half, then the high."""
    a = np.asarray(words, np.uint32)
    halves = a.reshape(-1).view(np.uint16).reshape(*a.shape, 2)
    return torch.from_numpy(halves.view(np.int16).copy()).view(torch.bfloat16).float().numpy()


def int8_pair(p, s_lo, s_hi):
    """`Front<8>::pair`: two offset-binary bytes of p into f32 2^23, minus
    2^23 + 128, the f32 pair's high halves as one bf16 pair."""
    def one(sel):
        f = byte_perm(p, 0x4B000000, sel).view(np.float32) - np.float32(8388736.0)
        return f.astype(np.float32).view(np.uint32)
    return byte_perm(one(s_lo), one(s_hi), 0x7632)


def int4_pair(w):
    """`Front<4>::pair`: lop3 (w & 0x000F000F) ^ 0x43084308, then the packed
    bf16 fma biased * 1 - 136, rounded to bf16."""
    biased = (np.asarray(w, np.uint32) & np.uint32(0x000F000F)) ^ np.uint32(0x43084308)
    vals = torch.from_numpy(bf16_pair(biased) * np.float32(1.0) - np.float32(136.0))
    bits = vals.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    return bits[..., 0] | (bits[..., 1] << np.uint32(16))


def int8_convert(lo, hi, sel):
    p = byte_perm(lo, hi, sel) ^ np.uint32(0x80808080)
    return int8_pair(p, 0x7650, 0x7651), int8_pair(p, 0x7652, 0x7653)


def int4_convert(lo, hi, sel):
    w = byte_perm(lo, hi, sel)
    return ((int4_pair(w), int4_pair(w >> np.uint32(8))),
            (int4_pair(w >> np.uint32(4)), int4_pair(w >> np.uint32(12))))


def test_int8_conversion_is_exact_on_all_256_codes():
    codes = np.arange(-128, 128, dtype=np.int8)
    words = codes.view(np.uint8).astype(np.uint32)
    # Each code as byte 0 and, shifted, as byte 1 of a word: one pair per code.
    lo = words | (np.roll(words, 1) << np.uint32(8))
    got = bf16_pair(int8_convert(lo, lo, 0x5410)[0])
    want = np.asarray(jquant.maybe_dequant(
        {"kernel_q": jnp.asarray(codes[:, None]), "scale": jnp.ones((1, 1), jnp.float32)},
        jnp.bfloat16).astype(jnp.float32))[:, 0]
    np.testing.assert_array_equal(got[:, 0], want)
    np.testing.assert_array_equal(got[:, 1], np.roll(want, 1))


def test_int4_conversion_is_exact_on_all_256_nibble_pairs():
    b = np.arange(256, dtype=np.uint32)   # every byte: a low and a high nibble
    lo = b | (np.roll(b, 7) << np.uint32(8)) | (np.roll(b, 3) << np.uint32(16)) \
        | (np.roll(b, 11) << np.uint32(24))
    (lo_a0, lo_a2), (hi_a0, hi_a2) = int4_convert(lo, lo[::-1].copy(), 0x5140)
    # The JAX package's codes of each byte, with unit scales.
    packed = b.astype(np.uint8).view(np.int8)[:, None]              # [K/2 = 256, N = 1]
    want = np.asarray(jquant.dequant_int4(
        {"kernel_q4": jnp.asarray(packed), "scale4": jnp.ones((1, 1), jnp.float32)},
        jnp.bfloat16).astype(jnp.float32))[:, 0]                     # low nibbles, then high
    lo_vals, hi_vals = want[:256], want[256:]
    np.testing.assert_array_equal(bf16_pair(lo_a0)[:, 0], lo_vals)
    np.testing.assert_array_equal(bf16_pair(hi_a0)[:, 0], hi_vals)
    np.testing.assert_array_equal(bf16_pair(lo_a0)[:, 1], np.roll(lo_vals, 7))
    np.testing.assert_array_equal(bf16_pair(hi_a0)[:, 1], np.roll(hi_vals, 7))
    np.testing.assert_array_equal(bf16_pair(lo_a2)[:, 0], lo_vals[::-1])
    np.testing.assert_array_equal(bf16_pair(hi_a2)[:, 1], np.roll(hi_vals, 7)[::-1])
    assert set(np.unique(want)) == set(range(-8, 8))


# -- a whole stage through every consumer thread ------------------------------------------


def swizzled(tile: np.ndarray) -> np.ndarray:
    """A [rows, 128 or 64] byte tile as TMA writes it with the 128- or
    64-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8), or
    c ^ ((r / 2) % 4)."""
    rows, width = tile.shape
    out = np.zeros(rows * width, np.uint8)
    for r in range(rows):
        for c in range(width // 16):
            at = c ^ (r & 7) if width == 128 else c ^ ((r >> 1) & 3)
            out[r * width + 16 * at:r * width + 16 * at + 16] = tile[r, 16 * c:16 * c + 16]
    return out


def stage_through_threads(smem: np.ndarray, bits: int, warpgroups: int, boxes):
    """Every consumer thread's reads and conversions of one stage, placed by
    the wgmma A-fragment layout at the k its x box gives: ([rows, K] values,
    [rows, K] counts of how often a (row, k) was written)."""
    width = 128 if bits == 8 else 64
    words = smem.view(np.uint32)
    tid = np.arange(128 * warpgroups)
    wg, warp, lane = tid // 128, (tid % 128) // 32, tid % 32
    t, g = lane & 3, lane >> 2
    r0 = 64 * wg + 16 * warp + g
    sel = np.where(t & 1, 0x7632, 0x5410) if bits == 8 else np.where(t & 1, 0x7362, 0x5140)
    rows = 64 * warpgroups
    K = max(boxes) + 64
    seen = np.zeros((rows, K), np.float32)
    count = np.zeros((rows, K), np.int64)
    for c in range(width // 16):
        def at(r):
            chunk = c ^ (r & 7) if bits == 8 else c ^ ((r >> 1) & 3)
            return (r * width + 16 * chunk + 4 * (t >> 1)) // 4
        lo0, hi0, lo1, hi1 = (words[at(r0)], words[at(r0) + 2], words[at(r0 + 8)],
                              words[at(r0 + 8) + 2])
        if bits == 8:
            a0, a2 = int8_convert(lo0, hi0, sel)
            a1, a3 = int8_convert(lo1, hi1, sel)
            steps = [((c >> 2, c & 3), (a0, a1, a2, a3))]
        else:
            (l0, l2), (h0, h2) = int4_convert(lo0, hi0, sel)
            (l1, l3), (h1, h3) = int4_convert(lo1, hi1, sel)
            steps = [((0, c), (l0, l1, l2, l3)), ((1, c), (h0, h1, h2, h3))]
        for (box, step), regs in steps:
            # The m64k16 A fragment: a0 (row, k 2t, 2t + 1), a1 (row + 8, the
            # same k), a2 (row, k 2t + 8, 2t + 9), a3 (row + 8, those k).
            for reg, dr, dk in zip(regs, (0, 8, 0, 8), (0, 0, 8, 8)):
                v = bf16_pair(reg)
                for e in range(2):
                    k = boxes[box] + 16 * step + 2 * t + dk + e
                    seen[r0 + dr, k] = v[:, e]
                    np.add.at(count, (r0 + dr, k), 1)
    return seen, count


def x_cols(bits: int, j: int, gq: int):
    """The kernel's Front<bits>::x_cols: stage j's two x boxes."""
    if bits == 8:
        return 128 * j, 128 * j + 64
    grp = j // gq
    k_lo = grp * gq * 128 + 64 * (j - grp * gq)
    return k_lo, k_lo + 64 * gq


@pytest.mark.parametrize("bits,group,warpgroups", [(8, 0, 1), (8, 0, 2), (4, 128, 1),
                                                     (4, 256, 2)])
def test_a_stage_through_every_thread_is_the_dequantized_tile(bits, group, warpgroups):
    rng = np.random.default_rng(bits + group + warpgroups)
    rows = 64 * warpgroups
    K = 512
    w = rng.standard_normal((rows, K)).astype(np.float32)
    if bits == 8:
        q, _ = tquant.quantize_kernel(torch.from_numpy(w))
        packed, codes = q.numpy(), q.numpy().astype(np.float32)
        stage_bytes, gq = 128, 1
    else:
        q4, scale4 = tquant.quantize_kernel_int4(torch.from_numpy(w), group)
        packed = q4.numpy()
        codes = tquant.unpack_int4(q4, K // group).numpy().astype(np.float32)
        stage_bytes, gq = 64, group // 128
    for j in range(K // 128):
        tile = packed[:, stage_bytes * j:stage_bytes * (j + 1)].view(np.uint8)
        boxes = x_cols(bits, j, gq)
        seen, count = stage_through_threads(swizzled(tile), bits, warpgroups, boxes)
        # Every (row, k) of the stage's two boxes written once, with its code.
        ks = sorted({boxes[b] + i for b in (0, 1) for i in range(64)})
        assert len(ks) == 128 and count.sum() == rows * 128
        assert (count[:, ks] == 1).all()
        np.testing.assert_array_equal(seen[:, ks], codes[:, ks])


# -- the schedule -------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_schedule_covers_every_tile_and_k_once_in_split_order(bits):
    for K, N in SHAPES.values():
        for M in ROWS:
            group = 128 if bits == 4 else 0
            plan = tqmm.schedule(M, N, K, H100_SMS, group)
            assert plan.n_rows == next(r for r in tqmm.X_ROWS if M <= r)
            assert plan.tiles * plan.block_n >= N > (plan.tiles - 1) * plan.block_n
            ranges = plan.k_ranges()
            assert [p for p, _, _ in ranges] == list(range(plan.splits))
            # Contiguous, non-empty, from 0 to the end of K, in split order.
            assert ranges[0][1] == 0 and ranges[-1][2] >= K > ranges[-1][1]
            for (_, _, end), (_, begin, _) in zip(ranges, ranges[1:]):
                assert end == begin
            assert all(begin < end for _, begin, end in ranges)
            if bits == 4:
                assert all(begin % group == 0 for _, begin, _ in ranges)
            # The card's slots: split only while the tiles leave SMs idle.
            slots = H100_SMS * tqmm.BLOCKS_PER_SM[plan.block_n]
            assert plan.splits == 1 or plan.tiles * plan.splits <= slots


@pytest.mark.parametrize("bits,group", [(8, 0), (4, 128), (4, 256)])
def test_the_schedule_summed_in_split_order_matches_the_plain_version(bits, group):
    """The kernel's arithmetic at a small shape: each split's f32 partial
    over its K range (per group for int4), the partials added in split
    order, the int8 scale last, against the plain version."""
    rng = np.random.default_rng(group + 1)
    M, N, K = 5, 256, 1536
    w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    plan = tqmm.schedule(M, N, K, 8, group)   # a small card, so that K splits
    assert plan.splits > 1
    total = torch.zeros(M, N)
    if bits == 8:
        q, scale = tquant.quantize_kernel(w)
        for _, k0, k1 in plan.k_ranges():
            total += x[:, k0:k1].float() @ q[:, k0:k1].float().T
        got, want = total * scale, tqmm.quantized_matmul_plain(x.float(), q, scale)
    else:
        q4, scale4 = tquant.quantize_kernel_int4(w, group)
        codes = tquant.unpack_int4(q4, K // group).float()
        for _, k0, k1 in plan.k_ranges():
            part = torch.zeros(M, N)
            for g0 in range(k0, k1, group):
                part += (x[:, g0:g0 + group].float() @ codes[:, g0:g0 + group].T) \
                    * scale4[:, g0 // group]
            total += part
        got, want = total, tqmm.quantized_matmul_int4_plain(x.float(), q4, scale4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_quant_matmul_forms_are_edits_of_the_committed_header():
    """Each form `experiments/quant_matmul_forms.py` builds on the card is a
    text edit of `csrc/quant_matmul_common.cuh` that still applies, and its
    ptxas reading keeps the largest registers and spills and the notes."""
    from vis_zephyr_tpu_torch.experiments import quant_matmul_forms as forms

    committed = forms.form_source([])
    for name, edits in forms.FORMS.items():
        assert (forms.form_source(edits) == committed) == (not edits), name
    log = ("ptxas info    : (C7513) Potential Performance Loss: wgmma.mma_async instructions "
           "are serialized due to non wgmma instructions defining input registers of a wgmma "
           "between start and end of the pipeline stage in the function 'qmm_kernel'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 146 registers, used 2 barriers, 16 bytes smem\n"
           "    32 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 2 barriers, 16 bytes smem\n")
    assert forms.ptxas_report(log) == {"registers": 168, "spill_bytes": 24, "notes": ["C7513"]}
