"""The port's int8 weights (`--load-8bit`) against the JAX package, on the CPU.

- `ops.quant.quantize_kernel` is bit-equal to the JAX package's on the
  transposed weight, values at ±absmax and half-way values included.
- K5's plain version `quantized_matmul_plain` against the JAX int8 Pallas
  `_kernel`, run in interpret mode through `quantized_matmul`'s grid and
  specs (smaller blocks, so that the kernel accumulates over several K steps
  and writes several N blocks). Inputs are bf16-representable, so both sum
  the same exact products in f32, in another order: max-abs error within
  1e-5 of the largest output.
- `qlinear` takes K5 once up to 128 rows, K5 on chunks of 128 rows and the
  rest up to `QMM_CHUNK_MAX_M` (the port's departure from the JAX gate) and
  the dequantize route above, each against the JAX `qdot`; a shape K5
  cannot take raises off the CPU.
- A quantized decoder and Q-Former: the port's own quantization equals the
  JAX package's tree carried over by the weight bridge, bit for bit, and the
  forwards agree to 1e-4 (the f32 model tests' tolerance).
- The slice: greedy tokens of the dense `generate` and of the paged batcher
  (int8 KV-fused pools, chunked admission) on int8 weights equal the JAX
  package's.
- `load_pretrained_model(load_8bit=True)` quantizes exactly the listed
  projections. (`--load-4bit` is held against the JAX package in
  `tests/test_torch_quant4.py`.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.models import mistral as jmistral
from vis_zephyr_tpu.models import qformer as jqformer
from vis_zephyr_tpu.ops import quant as jquant
from vis_zephyr_tpu.ops import quant_matmul as jqmm
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu_torch.models import builder as tbuilder
from vis_zephyr_tpu_torch.models import mistral as tmistral
from vis_zephyr_tpu_torch.models.convert import state_dict_from_jax
from vis_zephyr_tpu_torch.models.quant_linear import QuantLinear
from vis_zephyr_tpu_torch.ops import quant as tquant
from vis_zephyr_tpu_torch.ops import quant_matmul as tqmm
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)
TOL = dict(atol=1e-4, rtol=1e-4)
EOS = 2
j_mistral = jax.jit(jmistral.mistral_forward, static_argnums=(2,),
                    static_argnames=("logits_slice", "return_kv"))
j_qformer = jax.jit(jqformer.qformer_forward, static_argnums=(2,))
DECODER_PROJ = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
                "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_values(a):
    """numpy f32 values that bf16 represents exactly."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def jax_quantized(params):
    """The JAX package's `load_8bit` tree: int8 decoder layers and Q-Former."""
    out = dict(params)
    out["decoder"] = jax.tree_util.tree_map(
        np.asarray, jquant.quantize_decoder_layers(params["decoder"], bits=8))
    out["projector"] = jax.tree_util.tree_map(
        np.asarray, jquant.quantize_qformer(params["projector"]))
    return out


@pytest.fixture(scope="module")
def models():
    """(JAX float params, JAX int8 params, port model quantized by the port)."""
    params = jax_params_numpy(CFG, 3)
    port = port_model(params, CFG)
    tbuilder.quantize_weights(port)
    return params, jax_quantized(params), port


# -- quantization --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kernel_is_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((24, 64)).astype(np.float32)
    # Row 0: absmax 127 at +127 (scale exactly 1), so w / scale keeps its
    # half-way values: 2.5 → 2, -3.5 → -4, 0.5 → 0, 1.5 → 2 (half to even).
    w[0, :6] = [127.0, 2.5, -3.5, 0.5, 1.5, -126.5]
    w[1, 3] = -2.0 * np.abs(w[1]).max()   # absmax reached by a negative value
    w[2] = 0.0                            # all zero: the 1e-8 floor
    w = w if dtype == "float32" else _bf16_values(w)
    want = jquant.quantize_kernel(jnp.asarray(w.T, dtype=getattr(jnp, dtype)))
    q, scale = tquant.quantize_kernel(torch.from_numpy(w).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want["kernel_q"]).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["scale"])[0])
    assert q[0, :6].tolist() == [127, 2, -4, 0, 2, -126] and q[1, 3] == -127
    assert int(q[2].abs().max()) == 0
    for form, jform in ((QuantLinear(q, scale), want), (torch.nn.Linear(64, 24), None)):
        got = tquant.maybe_dequant(form, torch.float32)
        jwant = (np.asarray(jquant.maybe_dequant(jform, jnp.float32)).T if jform is not None
                 else form.weight.detach().numpy())
        np.testing.assert_array_equal(got.detach().numpy(), jwant)


def jax_int8_kernel(x, wq, scale, block_k=256, block_n=128):
    """The JAX package's int8 `_kernel` in interpret mode, through the grid
    and block specs of `quantized_matmul` (`quant_matmul.py:90-112`), which
    itself takes no `interpret` argument. x [M, K] f32, wq int8 [K, N],
    scale [1, N] → f32 [M, N]."""
    M, K = x.shape
    N = wq.shape[1]
    M_pad = max(8, -(-M // 8) * 8)
    x = jnp.pad(jnp.asarray(x), ((0, M_pad - M), (0, 0)))
    out = pl.pallas_call(
        jqmm._kernel,
        out_shape=jax.ShapeDtypeStruct((M_pad, N), jnp.float32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0,
            grid=(N // block_n, K // block_k),
            in_specs=[pl.BlockSpec((M_pad, block_k), lambda n, k: (0, k)),
                      pl.BlockSpec((block_k, block_n), lambda n, k: (k, n)),
                      pl.BlockSpec((1, block_n), lambda n, k: (0, n))],
            out_specs=pl.BlockSpec((M_pad, block_n), lambda n, k: (0, n)),
            scratch_shapes=[pltpu.VMEM((M_pad, block_n), jnp.float32)],
        ),
        interpret=True,
    )(x, jnp.asarray(wq), jnp.asarray(scale))
    return np.asarray(out[:M])


@pytest.mark.parametrize("M", [1, 8, 128])
def test_quantized_matmul_plain_matches_jax_pallas_kernel(M):
    rng = np.random.default_rng(M)
    K, N = 512, 256
    w = rng.standard_normal((N, K)).astype(np.float32)
    x = _bf16_values(rng.standard_normal((M, K)).astype(np.float32))
    q, scale = tquant.quantize_kernel(torch.from_numpy(w))
    want = jax_int8_kernel(x, q.numpy().T, scale.numpy()[None])
    got = tqmm.quantized_matmul(torch.from_numpy(x), q, scale)  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (M, N)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    bf16 = tqmm.quantized_matmul(torch.from_numpy(x).to(torch.bfloat16), q, scale)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, got.to(torch.bfloat16))  # the same f32 sums, rounded once


@pytest.mark.parametrize("lead", [(1,), (2, 64), (1, 129), (3, 100), (32, 5), (2, 128),
                                  (1, tqmm.QMM_CHUNK_MAX_M + 1)],
                         ids=["M1", "M128", "M129", "M300", "M160", "M256", "M above the chunks"])
def test_qlinear_routes_by_rows_and_matches_jax_qdot(lead, monkeypatch):
    """Up to QMM_MAX_M rows take K5 once (its plain version on the CPU), up to
    QMM_CHUNK_MAX_M K5 on chunks of QMM_MAX_M rows and the rest (160: the
    32-slot verify step at S = 5), above it the dequantize route; all equal
    the JAX `qdot` on the same weights (whose gate dequantizes above 128
    rows: within the K5 tests' 1e-5)."""
    rng = np.random.default_rng(sum(lead))
    K, N = 96, 80
    w = rng.standard_normal((N, K)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    q, scale = tquant.quantize_kernel(torch.from_numpy(w))
    layer = QuantLinear(q, scale, torch.from_numpy(bias))
    plain_calls = []
    plain = tqmm.quantized_matmul_plain
    monkeypatch.setattr(tqmm, "quantized_matmul_plain",
                        lambda *a: plain_calls.append(a[0].shape) or plain(*a))
    before = tqmm.dequant_calls
    got = layer(torch.from_numpy(x))
    p = {"kernel_q": q.numpy().T, "scale": scale.numpy()[None], "bias": bias}
    want = np.asarray(jqmm.qdot(jnp.asarray(x), p)) + bias
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    M = int(np.prod(lead))
    chunks = [] if M > tqmm.QMM_CHUNK_MAX_M else [128] * (M // 128) + [M % 128] * (M % 128 > 0)
    assert tqmm.row_chunks(M) == chunks
    assert plain_calls == [(c, K) for c in chunks]
    assert tqmm.dequant_calls - before == (0 if chunks else 1)
    assert tqmm.launches == 0  # nothing launches on the CPU


@pytest.mark.parametrize("case", ["K not a multiple of 16", "weight not contiguous"])
def test_k5_refuses_what_it_cannot_take_off_the_cpu(case):
    """Off the CPU (a meta tensor stands for the card's) a shape K5 cannot
    take at M ≤ 128 raises; it never drops to the dequantize route."""
    K = 40 if case.startswith("K") else 64
    x = torch.empty((4, K), dtype=torch.bfloat16, device="meta")
    q = torch.empty((32, K), dtype=torch.int8, device="meta")
    if case.startswith("weight"):
        q = torch.empty((K, 32), dtype=torch.int8, device="meta").T
    layer = QuantLinear(q, torch.empty(32, device="meta"))
    before = tqmm.dequant_calls
    with pytest.raises(ValueError):
        layer(x)
    assert tqmm.dequant_calls == before and tqmm.launches == 0


# -- the quantized model ---------------------------------------------------------------


@pytest.mark.parametrize("part", ["decoder", "projector"])
def test_port_quantization_equals_the_bridged_jax_tree(models, part):
    """The port's int8 model state equals the JAX package's quantized tree
    carried over by `state_dict_from_jax`, bit for bit, and loads strictly."""
    _, qparams, port = models
    bridged = state_dict_from_jax(qparams, TCFG)
    own = {f"{part}.{k}": v for k, v in getattr(port, part).state_dict().items()}
    assert sorted(own) == sorted(k for k in bridged if k.startswith(part + "."))
    for key, value in own.items():
        assert value.dtype == bridged[key].dtype, key
        assert torch.equal(value, bridged[key]), key
    n_int8 = sum(v.dtype == torch.int8 for v in own.values())
    # Per Q-Former block: packed self in_proj, cross q, k, v, two out_projs, two ffn.
    assert n_int8 == (7 * CFG.decoder.num_layers if part == "decoder"
                      else 8 * CFG.projector.num_blocks)
    fresh = tbuilder.quantize_weights(port_model(models[0], CFG))
    fresh.load_state_dict(bridged, strict=True)


def test_quantized_decoder_matches_jax(models):
    _, qparams, port = models
    rng = np.random.default_rng(5)
    B, T = 2, 10
    ids = rng.integers(0, CFG.decoder.vocab_size, (B, T))
    valid = np.ones((B, T), bool)
    valid[1, 7:] = False
    positions = np.where(valid, np.cumsum(valid, 1) - 1, 0).astype(np.int32)
    emb = np.asarray(jmistral.embed(qparams["decoder"], jnp.asarray(ids)))
    want, (wk, _) = j_mistral(qparams["decoder"], jnp.asarray(emb), CFG.decoder,
                                             jnp.asarray(positions),
                                             attn_valid=jnp.asarray(valid), return_kv=True)
    got, (gk, _) = tmistral.mistral_forward(port.decoder, _t(emb), TCFG.decoder, _t(positions),
                                            attn_valid=_t(valid), return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)


def test_quantized_qformer_matches_jax(models):
    _, qparams, port = models
    rng = np.random.default_rng(6)
    n, T_vis, L = 3, CFG.vision.tokens_per_image, 5
    visual = rng.standard_normal((n, T_vis, CFG.projector.visual_hidden_size)).astype(np.float32)
    text = rng.standard_normal((n, L, CFG.projector.hidden_size)).astype(np.float32)
    mask = np.ones((n, L), bool)
    mask[1, 3:] = False
    want = j_qformer(qparams["projector"], jnp.asarray(visual), CFG.projector,
                                    text_embeddings=jnp.asarray(text),
                                    text_mask=jnp.asarray(mask))
    got = port.projector(_t(visual), text_embeddings=_t(text), text_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the slice: greedy tokens on int8 weights ------------------------------------------


def test_dense_generate_greedy_tokens_match_jax_int8(models):
    _, qparams, port = models
    rng = np.random.default_rng(7)
    side = CFG.vision.image_size
    ids = np.array([[1, 5, IMAGE_TOKEN_INDEX, 7, 9, 11, 13]], np.int64)
    pixels = rng.standard_normal((1, 3, side, side, 3)).astype(np.float32)
    valid = np.array([[True, True, False]])
    want = jgen.generate(qparams, ids, pixels, valid, CFG, jgen.SamplingConfig(max_new_tokens=8))
    args = (port, _t(ids), _t(pixels), _t(valid), TCFG)
    got = tgen.generate(*args, tgen.SamplingConfig(max_new_tokens=8))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(set(np.asarray(want)[0].tolist())) > 1, "a constant reply means little"
    assert list(tgen.generate_stream(*args, tgen.SamplingConfig(max_new_tokens=8))) == \
        list(jgen.generate_stream(qparams, ids, pixels, valid, CFG,
                                  jgen.SamplingConfig(max_new_tokens=8)))


def _paged_requests():
    """[(ids, images, valid, max_new_tokens, submit before step)]: with and
    without an image, a prompt longer than a page, two late arrivals."""
    rng = np.random.default_rng(8)
    side = CFG.vision.image_size

    def request(T, with_image, at=0):
        ids = rng.integers(5, CFG.decoder.vocab_size, (T,)).astype(np.int64)
        images = valid = None
        if with_image:
            ids[1] = IMAGE_TOKEN_INDEX
            images = rng.standard_normal((3, side, side, 3)).astype(np.float32)
            valid = np.array([True, True, False])
        return ids, images, valid, at

    return [request(5, True), request(20, False), request(9, False),
            request(8, True, at=3), request(11, False, at=3)]


def _drive(batcher, requests, max_steps=200):
    handles = {}
    for step in range(max_steps):
        for i, (ids, images, valid, at) in enumerate(requests):
            if at == step:
                handles[i] = batcher.submit(ids, images, valid)
        if len(handles) == len(requests) and not batcher.has_work:
            break
        batcher.step()
    return [list(batcher.stream(handles[i])) for i in range(len(requests))]


def test_paged_batcher_greedy_tokens_match_jax_int8(models):
    _, qparams, port = models
    kw = dict(max_slots=4, cache_len=64, page_size=16, num_pages=32, kv_quant=True,
              kv_fused=True, prefill_chunk=16)
    jb = jpaged.PagedBatcher(qparams, CFG,
                             sampling=jgen.SamplingConfig(max_new_tokens=6, eos_token_id=EOS), **kw)
    tb = tpaged.PagedBatcher(port, TCFG,
                             sampling=tgen.SamplingConfig(max_new_tokens=6, eos_token_id=EOS), **kw)
    want = _drive(jb, _paged_requests())
    got = _drive(tb, _paged_requests())
    assert got == want
    assert sum(len(r) for r in want) > 10 and not tb.has_work


# -- the builder and the flags -----------------------------------------------------------


def test_load_8bit_quantizes_exactly_the_listed_projections(models, tmp_path):
    """`load_pretrained_model(load_8bit=True)` on the CPU: every decoder
    projection and every Q-Former projection is int8 and equals the port's
    quantization of the float weights; embeddings, lm_head, norms, biases,
    learned queries and the CLIP tower stay float and unchanged."""
    from safetensors.torch import save_file

    params, _, quantized = models
    float_model = port_model(params, CFG)
    base, tower, model_dir = (tmp_path / name for name in ("base", "tower", "model"))
    for d in (base, tower, model_dir):
        d.mkdir()
    save_file({k: v.contiguous() for k, v in float_model.decoder.state_dict().items()},
              str(base / "model.safetensors"))
    torch.save({f"vision_model.{k}": v for k, v in float_model.vision.state_dict().items()},
               tower / "pytorch_model.bin")
    torch.save({f"model.mm_projector.{k}": v for k, v in float_model.projector.state_dict().items()},
               model_dir / "mm_projector.bin")
    (model_dir / "config.json").write_text(CFG.to_json())

    _, loaded, _, _ = tbuilder.load_pretrained_model(
        str(model_dir), model_base=str(base), vision_tower_path=str(tower),
        dtype=torch.float32, device="cpu", load_8bit=True)
    L, nb = CFG.decoder.num_layers, CFG.projector.num_blocks
    for i in range(L):
        for name in DECODER_PROJ:
            assert isinstance(loaded.decoder.model.layers[i].get_submodule(name), QuantLinear)
    want_int8 = {f"decoder.model.layers.{i}.{name}.weight_q" for i in range(L) for name in DECODER_PROJ}
    for i in range(nb):
        pre = f"projector.blocks.{i}"
        want_int8 |= {f"{pre}.self_attn.in_proj_weight_q", f"{pre}.self_attn.out_proj.weight_q",
                      f"{pre}.cross_attn.out_proj.weight_q", f"{pre}.ffn.0.weight_q",
                      f"{pre}.ffn.2.weight_q"}
        want_int8 |= {f"{pre}.cross_attn.{x}_proj_weight_q" for x in "qkv"}
    got = loaded.state_dict()
    assert {k for k, v in got.items() if v.dtype == torch.int8} == want_int8
    assert set(got) == set(quantized.state_dict())
    for key, value in quantized.state_dict().items():
        assert torch.equal(got[key], value), key
    untouched = float_model.state_dict()
    for key, value in got.items():
        if value.dtype != torch.int8 and not key.endswith("scale"):
            assert torch.equal(value, untouched[key]), key
