"""The port's int4 weights (`--load-4bit`) against the JAX package, on the CPU.

- `ops.quant.quantize_kernel_int4` is bit-equal to the JAX package's on the
  transposed weight (f32 and bf16 weights, values at ±absmax, half-way
  values, an all-zero group, `group = min(group, K)`), and refuses what it
  refuses; `unpack_int4` and `dequant_int4` are bit-equal to the JAX
  package's on all 225 bytes the packing makes.
- K6's plain version `quantized_matmul_int4_plain` against the JAX int4
  Pallas kernel in interpret mode (K = 1024: 8 groups, so two grid steps of 4
  groups accumulate). Inputs are bf16-representable, so both sum the same
  exact products in f32, in another order: max-abs error within 1e-5 of the
  largest output.
- `qlinear`'s int4 route takes K6 under the JAX gate (M ≤ 128, N and the
  group multiples of 128), K6 on chunks of 128 rows up to `QMM_CHUNK_MAX_M`
  (the port's departure from that gate) and the dequantize route otherwise,
  each against the JAX `qdot`; what K6 cannot take raises off the CPU.
- The int4 model, at `smoke_config` (the decoder at production head_dim 128,
  so every projection passes K6's gate; its Q-Former widened to the
  decoder's width, so that images reach the decoder): the port's
  quantization equals the JAX package's tree carried over by the weight
  bridge, bit for bit, and the decoder forwards agree to 1e-4 on 20 rows
  (K6's plain version) and on 144 (K6's plain version on chunks of 128 and
  16 rows, against the JAX dequantize route).
- The slice: greedy tokens of the dense `generate` and of the paged batcher
  (int8 KV-fused pools, chunked admission) on int4 weights equal the JAX
  package's, through K6's plain version.
- `--load-4bit` through the CLI, the server and the builder quantizes the
  decoder's projections to int4 and the Q-Former's to int8, wins over
  `--load-8bit`, and leaves everything else untouched.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import smoke_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.models import mistral as jmistral
from vis_zephyr_tpu.ops import quant as jquant
from vis_zephyr_tpu.ops import quant_matmul as jqmm
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu_torch.models import builder as tbuilder
from vis_zephyr_tpu_torch.models import mistral as tmistral
from vis_zephyr_tpu_torch.models.convert import state_dict_from_jax
from vis_zephyr_tpu_torch.models.quant_linear import QuantLinear, QuantLinear4
from vis_zephyr_tpu_torch.ops import quant as tquant
from vis_zephyr_tpu_torch.ops import quant_matmul as tqmm
from vis_zephyr_tpu_torch.serve import api as tapi
from vis_zephyr_tpu_torch.serve import cli as tcli
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged


def _smoke_multimodal():
    """`smoke_config` with the Q-Former as wide as its decoder, as in the full
    config: `smoke_config`'s own 64-wide Q-Former cannot feed its 256-wide
    decoder, in either package."""
    cfg = smoke_config(vocab_size=256)
    width = cfg.decoder.hidden_size
    return dataclasses.replace(cfg, projector=dataclasses.replace(
        cfg.projector, hidden_size=width, ffn_dim=2 * width))


CFG = _smoke_multimodal()
TCFG = port_config(CFG)
TOL = dict(atol=1e-4, rtol=1e-4)
EOS = 2
DECODER_PROJ = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
                "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
j_mistral = jax.jit(jmistral.mistral_forward, static_argnums=(2,),
                    static_argnames=("logits_slice", "return_kv"))


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_values(a):
    """numpy f32 values that bf16 represents exactly."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def jax_quantized(params):
    """The JAX package's `load_4bit` tree: int4 decoder layers, int8 Q-Former."""
    out = dict(params)
    out["decoder"] = jax.tree_util.tree_map(
        np.asarray, jquant.quantize_decoder_layers(params["decoder"], bits=4))
    out["projector"] = jax.tree_util.tree_map(
        np.asarray, jquant.quantize_qformer(params["projector"]))
    return out


@pytest.fixture(scope="module")
def models():
    """(JAX float params, JAX int4 params, port model quantized by the port)."""
    params = jax_params_numpy(CFG, 3)
    port = tbuilder.quantize_weights(port_model(params, CFG), bits=4)
    return params, jax_quantized(params), port


class _PlainCalls:
    """Counts the calls of K6's plain version (on the CPU the K6 route's whole
    work; `launches4` counts launches on the card only)."""

    def __init__(self, monkeypatch):
        self.shapes = []
        plain = tqmm.quantized_matmul_int4_plain
        monkeypatch.setattr(tqmm, "quantized_matmul_int4_plain",
                            lambda *a: self.shapes.append(tuple(a[0].shape)) or plain(*a))


# -- quantization and unpacking ------------------------------------------------------


@pytest.mark.parametrize("dtype,group", [("float32", 128), ("bfloat16", 128), ("float32", 512)],
                         ids=["f32", "bf16", "group=min(group, K)"])
def test_quantize_kernel_int4_is_bit_equal_to_jax(dtype, group):
    rng = np.random.default_rng(0)
    N, K = 24, 256
    w = rng.standard_normal((N, K)).astype(np.float32)
    # Row 0, group 0: absmax 7 at +7 (scale exactly 1), so w / scale keeps its
    # half-way values: 2.5 → 2, -3.5 → -4, 0.5 → 0, 1.5 → 2, -6.5 → -6.
    w[0, :6] = [7.0, 2.5, -3.5, 0.5, 1.5, -6.5]
    w[1, 200] = -2.0 * np.abs(w[1]).max()   # absmax reached by a negative value
    w[2, :128] = 0.0                         # an all-zero group: the 1e-8 floor
    w = w if dtype == "float32" else _bf16_values(w)
    want = jquant.quantize_kernel_int4(jnp.asarray(w.T, dtype=getattr(jnp, dtype)), group=group)
    q4, scale4 = tquant.quantize_kernel_int4(torch.from_numpy(w).to(getattr(torch, dtype)), group)
    G = K // min(group, K)
    assert q4.dtype == torch.int8 and q4.shape == (N, K // 2)
    assert scale4.dtype == torch.float32 and scale4.shape == (N, G)
    np.testing.assert_array_equal(q4.numpy(), np.asarray(want["kernel_q4"]).T)
    np.testing.assert_array_equal(scale4.numpy(), np.asarray(want["scale4"]).T)
    codes = tquant.unpack_int4(q4, G)
    if group == 128:
        assert codes[0, :6].tolist() == [7, 2, -4, 0, 2, -6] and scale4[0, 0] == 1.0
        assert int(codes[2, :128].abs().max()) == 0
    assert codes[1, 200] == -7 and int(codes.abs().max()) == 7
    form = QuantLinear4(q4, scale4)
    np.testing.assert_array_equal(tquant.maybe_dequant(form, torch.float32).numpy(),
                                  np.asarray(jquant.maybe_dequant(want, jnp.float32)).T)


@pytest.mark.parametrize("K,group", [(96, 64), (6, 3)], ids=["K % group", "odd group"])
def test_quantize_kernel_int4_refuses_what_jax_refuses(K, group):
    w = np.ones((4, K), np.float32)
    with pytest.raises(ValueError):
        jquant.quantize_kernel_int4(jnp.asarray(w.T), group=group)
    with pytest.raises(ValueError):
        tquant.quantize_kernel_int4(torch.from_numpy(w), group)


@pytest.mark.parametrize("num_groups", [1, 3])
def test_unpack_and_dequant_int4_are_bit_equal_to_jax_for_every_code_pair(num_groups):
    """All 225 bytes the packing makes (every pair of codes in -7..7), built
    with numpy: the port's int8 shifts wrap and sign-extend as JAX's do."""
    lo, hi = np.meshgrid(np.arange(-7, 8), np.arange(-7, 8), indexing="ij")
    byte = ((lo & 0x0F) | (hi << 4)).astype(np.uint8).view(np.int8).reshape(15, 15)
    # [N = 15, K/2 = 30]: each row holds 15 pairs twice over, split into groups.
    packed = np.concatenate([byte, byte[::-1]], axis=1)
    got = tquant.unpack_int4(torch.from_numpy(packed), num_groups).numpy()
    want = np.asarray(jquant.unpack_int4(jnp.asarray(packed.T), num_groups)).T
    np.testing.assert_array_equal(got, want)
    # Independently of JAX: per group, the low nibbles' codes then the high ones'.
    half = 30 // num_groups
    codes = got.reshape(15, num_groups, 2, half)
    p = packed.reshape(15, num_groups, half).astype(np.int32)
    np.testing.assert_array_equal(codes[:, :, 0], ((p & 0x0F) ^ 8) - 8)
    np.testing.assert_array_equal(codes[:, :, 1], p >> 4)
    scale4 = np.random.default_rng(1).random((15, num_groups)).astype(np.float32) + 0.01
    for dtype in ("float32", "bfloat16"):
        got = tquant.dequant_int4(torch.from_numpy(packed), torch.from_numpy(scale4),
                                  getattr(torch, dtype)).float().numpy()
        want = jquant.dequant_int4({"kernel_q4": jnp.asarray(packed.T),
                                    "scale4": jnp.asarray(scale4.T)}, getattr(jnp, dtype))
        np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32)).T)


# -- K6's plain version and the qlinear route -----------------------------------------------


@pytest.mark.parametrize("M", [1, 7, 32])
def test_quantized_matmul_int4_plain_matches_jax_pallas_kernel(M):
    rng = np.random.default_rng(M)
    K, N = 1024, 256
    w = rng.standard_normal((N, K)).astype(np.float32)
    x = _bf16_values(rng.standard_normal((M, K)).astype(np.float32))
    q4, scale4 = tquant.quantize_kernel_int4(torch.from_numpy(w))
    want = np.asarray(jqmm.quantized_matmul_int4(
        jnp.asarray(x), jnp.asarray(q4.numpy().T), jnp.asarray(scale4.numpy().T),
        out_dtype=jnp.float32, interpret=True))
    got = tqmm.quantized_matmul_int4(torch.from_numpy(x), q4, scale4)  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (M, N)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    bf16 = tqmm.quantized_matmul_int4(torch.from_numpy(x).to(torch.bfloat16), q4, scale4)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, got.to(torch.bfloat16))  # the same f32 sums, rounded once


@pytest.mark.parametrize("lead,N,group,k6", [
    ((1,), 256, 128, True), ((2, 64), 256, 128, True), ((1, 129), 256, 128, True),
    ((3,), 256, 64, False), ((3,), 192, 128, False), ((32, 5), 256, 128, True),
    ((2, 128), 256, 128, True), ((1, tqmm.QMM_CHUNK_MAX_M + 1), 256, 128, False)],
    ids=["M1", "M128", "M129", "group 64", "N 192", "M160", "M256", "M above the chunks"])
def test_qlinear_int4_routes_by_the_jax_gate_and_matches_jax_qdot(lead, N, group, k6, monkeypatch):
    """N and the group multiples of 128 take K6 (its plain version on the
    CPU): once up to 128 rows, on chunks of 128 rows and the rest up to
    QMM_CHUNK_MAX_M; anything else the dequantize route. All equal the JAX
    `qdot` on the same weights."""
    rng = np.random.default_rng(sum(lead) + N + group)
    K = 256
    w = rng.standard_normal((N, K)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    q4, scale4 = tquant.quantize_kernel_int4(torch.from_numpy(w), group)
    layer = QuantLinear4(q4, scale4, torch.from_numpy(bias))
    calls = _PlainCalls(monkeypatch)
    before = tqmm.dequant4_calls, tqmm.dequant_calls
    got = layer(torch.from_numpy(x))
    p = {"kernel_q4": q4.numpy().T, "scale4": scale4.numpy().T}
    want = np.asarray(jqmm.qdot(jnp.asarray(x), p)) + bias
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    M = int(np.prod(lead))
    assert calls.shapes == ([(c, K) for c in tqmm.row_chunks(M)] if k6 else [])
    assert len(calls.shapes) == (-(-M // 128) if k6 else 0)
    assert (tqmm.dequant4_calls - before[0], tqmm.dequant_calls - before[1]) == (0 if k6 else 1, 0)
    assert tqmm.launches4 == 0 and tqmm.launches == 0  # nothing launches on the CPU


@pytest.mark.parametrize("case", ["x float16", "weight not contiguous", "scale4 on another device"])
def test_k6_refuses_what_it_cannot_take_off_the_cpu(case):
    """Off the CPU (a meta tensor stands for the card's) an input inside the
    gate that K6 cannot take raises; it never drops to the dequantize route."""
    K, N = 256, 128
    x = torch.empty((4, K), dtype=torch.float16 if case.startswith("x") else torch.bfloat16,
                    device="meta")
    q4 = torch.empty((N, K // 2), dtype=torch.int8, device="meta")
    if case.startswith("weight"):
        q4 = torch.empty((K // 2, N), dtype=torch.int8, device="meta").T
    scale4 = torch.empty((N, K // 128), device="cpu" if case.startswith("scale4") else "meta")
    layer = QuantLinear4(q4, scale4)
    before = tqmm.dequant4_calls
    with pytest.raises((TypeError, ValueError)):
        layer(x)
    assert tqmm.dequant4_calls == before and tqmm.launches4 == 0


# -- the int4 model -------------------------------------------------------------------


@pytest.mark.parametrize("part", ["decoder", "projector"])
def test_port_int4_quantization_equals_the_bridged_jax_tree(models, part):
    """The port's `load_4bit` state (int4 decoder, int8 Q-Former) equals the
    JAX package's quantized tree carried over by `state_dict_from_jax`, bit
    for bit, and loads strictly."""
    _, qparams, port = models
    bridged = state_dict_from_jax(qparams, TCFG)
    own = {f"{part}.{k}": v for k, v in getattr(port, part).state_dict().items()}
    assert sorted(own) == sorted(k for k in bridged if k.startswith(part + "."))
    for key, value in own.items():
        assert value.dtype == bridged[key].dtype, key
        assert torch.equal(value, bridged[key]), key
    if part == "decoder":
        assert {k for k in own if k.endswith("weight_q4")} == {
            f"decoder.model.layers.{i}.{p}.weight_q4"
            for i in range(CFG.decoder.num_layers) for p in DECODER_PROJ}
        assert own["decoder.model.layers.0.mlp.down_proj.scale4"].shape == \
            (CFG.decoder.hidden_size, CFG.decoder.intermediate_size // 128)
    else:
        assert sum(k.endswith("weight_q") for k in own) == 8 * CFG.projector.num_blocks
        assert not any(k.endswith("weight_q4") for k in own)
    port.load_state_dict(bridged, strict=True)


@pytest.mark.parametrize("T,chunks", [(10, 1), (72, 2)], ids=["20 rows", "144 rows"])
def test_int4_decoder_matches_jax(models, T, chunks, monkeypatch):
    """Two rows of T tokens: every projection takes K6 (its plain version on
    the CPU), once up to 128 rows and on chunks of 128 rows and the rest
    above (the JAX package dequantizes there)."""
    _, qparams, port = models
    rng = np.random.default_rng(5)
    B = 2
    ids = rng.integers(0, CFG.decoder.vocab_size, (B, T))
    valid = np.ones((B, T), bool)
    valid[1, T - 3:] = False
    positions = np.where(valid, np.cumsum(valid, 1) - 1, 0).astype(np.int32)
    emb = np.asarray(jmistral.embed(qparams["decoder"], jnp.asarray(ids)))
    want, (wk, _) = j_mistral(qparams["decoder"], jnp.asarray(emb), CFG.decoder,
                              jnp.asarray(positions), attn_valid=jnp.asarray(valid),
                              return_kv=True)
    calls = _PlainCalls(monkeypatch)
    before = tqmm.dequant4_calls
    got, (gk, _) = tmistral.mistral_forward(port.decoder, _t(emb), TCFG.decoder, _t(positions),
                                            attn_valid=_t(valid), return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    n = 7 * CFG.decoder.num_layers
    assert (len(calls.shapes), tqmm.dequant4_calls - before) == (n * chunks, 0)


# -- the slice: greedy tokens on int4 weights -----------------------------------------------


def test_dense_generate_greedy_tokens_match_jax_int4(models, monkeypatch):
    """Every decoder projection of the prefill and of each decode step goes
    through K6's plain version."""
    _, qparams, port = models
    cfg = CFG
    rng = np.random.default_rng(7)
    side = cfg.vision.image_size
    ids = np.array([[1, 5, IMAGE_TOKEN_INDEX, 7, 9, 11, 13]], np.int64)
    pixels = rng.standard_normal((1, 3, side, side, 3)).astype(np.float32)
    valid = np.array([[True, True, False]])
    want = jgen.generate(qparams, ids, pixels, valid, cfg, jgen.SamplingConfig(max_new_tokens=8))
    calls = _PlainCalls(monkeypatch)
    before = tqmm.dequant4_calls
    got = tgen.generate(port, _t(ids), _t(pixels), _t(valid), TCFG,
                        tgen.SamplingConfig(max_new_tokens=8))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(set(np.asarray(want)[0].tolist())) > 1, "a constant reply means little"
    assert len(calls.shapes) > 0 and tqmm.dequant4_calls == before


def _paged_requests(cfg):
    """[(ids, images, valid, submit before step)]: with and without an image,
    a prompt longer than a page, two late arrivals."""
    rng = np.random.default_rng(8)
    side = cfg.vision.image_size

    def request(T, with_image, at=0):
        ids = rng.integers(5, cfg.decoder.vocab_size, (T,)).astype(np.int64)
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


def test_paged_batcher_greedy_tokens_match_jax_int4(models, monkeypatch):
    """Int8 KV-fused pools, chunked admission: every decode step's and
    chunk's projections through K6's plain version."""
    _, qparams, port = models
    cfg = CFG
    kw = dict(max_slots=4, cache_len=64, page_size=16, num_pages=32, kv_quant=True,
              kv_fused=True, prefill_chunk=16)
    jb = jpaged.PagedBatcher(qparams, cfg,
                             sampling=jgen.SamplingConfig(max_new_tokens=6, eos_token_id=EOS), **kw)
    tb = tpaged.PagedBatcher(port, TCFG,
                             sampling=tgen.SamplingConfig(max_new_tokens=6, eos_token_id=EOS), **kw)
    want = _drive(jb, _paged_requests(cfg))
    calls = _PlainCalls(monkeypatch)
    got = _drive(tb, _paged_requests(cfg))
    assert got == want
    assert sum(len(r) for r in want) > 10 and not tb.has_work
    assert len(calls.shapes) > 0


# -- the builder and the flags -----------------------------------------------------------


@pytest.fixture(scope="module")
def hf_dirs(models, tmp_path_factory):
    """The float model saved as an HF decoder dir, a CLIP tower dir and a
    model dir with `mm_projector.bin`."""
    from safetensors.torch import save_file

    float_model = port_model(models[0], CFG)
    root = tmp_path_factory.mktemp("hf")
    base, tower, model_dir = (root / name for name in ("base", "tower", "model"))
    for d in (base, tower, model_dir):
        d.mkdir()
    save_file({k: v.contiguous() for k, v in float_model.decoder.state_dict().items()},
              str(base / "model.safetensors"))
    torch.save({f"vision_model.{k}": v for k, v in float_model.vision.state_dict().items()},
               tower / "pytorch_model.bin")
    torch.save({f"model.mm_projector.{k}": v for k, v in float_model.projector.state_dict().items()},
               model_dir / "mm_projector.bin")
    (model_dir / "config.json").write_text(CFG.to_json())
    return base, tower, model_dir, float_model


class _Loaded(Exception):
    """Stops an entry point once its model is loaded."""


@pytest.mark.parametrize("entry", ["cli", "api", "builder"])
def test_load_4bit_quantizes_the_decoder_int4_and_the_qformer_int8(models, hf_dirs, entry,
                                                                   monkeypatch):
    """`--load-4bit` (with `--load-8bit` too: 4 bits win, as in the JAX
    builder) through the CLI, the server and the builder, on the CPU: every
    decoder projection is a `QuantLinear4`, every Q-Former projection int8,
    each equal to the port's own quantization of the float weights;
    embeddings, lm_head, norms, biases, learned queries and the CLIP tower
    stay float and unchanged."""
    base, tower, model_dir, float_model = hf_dirs
    real = tbuilder.load_pretrained_model
    seen = {}

    def on_cpu(model_path, **kw):
        seen["flags"] = (kw["load_8bit"], kw["load_4bit"])
        seen["model"] = real(model_path, **dict(kw, dtype=torch.float32, device="cpu"))[1]
        raise _Loaded

    flags = ["--model-path", str(model_dir), "--model-base", str(base), "--vision-tower",
             str(tower), "--load-8bit", "--load-4bit"]
    if entry == "cli":
        assert tcli.build_parser().parse_args(flags + ["--image-file", "x"]).load_4bit
        monkeypatch.setattr(tcli, "load_pretrained_model", on_cpu)
        with pytest.raises(_Loaded):
            tcli.main(flags + ["--image-file", "x"])
    elif entry == "api":
        monkeypatch.setattr(tbuilder, "load_pretrained_model", on_cpu)
        with pytest.raises(_Loaded):
            tapi.main(flags)
    else:
        with pytest.raises(_Loaded):
            on_cpu(str(model_dir), model_base=str(base), vision_tower_path=str(tower),
                   load_8bit=True, load_4bit=True)
    assert seen["flags"] == (True, True)
    loaded = seen["model"]
    for i in range(CFG.decoder.num_layers):
        for name in DECODER_PROJ:
            assert isinstance(loaded.decoder.model.layers[i].get_submodule(name), QuantLinear4)
    for block in loaded.projector.blocks:
        assert isinstance(block.ffn[0], QuantLinear) and isinstance(block.self_attn.out_proj, QuantLinear)
    got = loaded.state_dict()
    quantized = models[2].state_dict()
    assert set(got) == set(quantized)
    for key, value in quantized.items():
        assert torch.equal(got[key], value), key
    assert {k for k, v in got.items() if v.dtype == torch.int8} == \
        {k for k in got if k.endswith(("weight_q4", "weight_q"))}
    untouched = float_model.state_dict()
    for key, value in got.items():
        if value.dtype != torch.int8 and not key.endswith(("scale", "scale4")):
            assert torch.equal(value, untouched[key]), key
