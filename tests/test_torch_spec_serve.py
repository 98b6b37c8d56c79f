"""The port's speculative serving paths against the JAX package, on the CPU
at `tiny_config` in f32 (the JAX side runs its Pallas kernels in interpret
mode; the port's wrappers take their plain versions on CPU tensors).

- `_propose_lookup` returns what the JAX function returns on seeded
  histories, and `LookupHistory` (the incremental form both served paths
  keep) what `_propose_lookup` returns on every prefix;
- `decode_verify` logits (one multi-token dense-cache append) agree with the
  JAX function's to 1e-4, the model parity tests' tolerance;
- `generate_stream(lookahead=k)` streams the same greedy tokens as the JAX
  package's speculative stream and as the port's own `lookahead=0`, for a
  text prompt, a repetitive prompt and an image;
- `PagedBatcher(lookahead=4)` gives every request the tokens of its own
  `lookahead=0`, with chunked admission over int8 fused pools and a sliding
  window (and there the JAX `PagedBatcher(lookahead=4)`'s too) and with
  whole admission over f32 split pools, a slot filling `cache_len` exactly;
- the verify steps run over fixed buffers, which a step captured on the
  card reads: the paged batcher's candidates and `active` go into the same
  two tensors every step, and the serialized stream speculates on the fixed
  cache that `burst_cache` hands it, across requests, with the JAX stream's
  tokens;
- `--lookahead` reaches the serialized path through the CLI and the paged
  batcher through the server, whose replies equal the non-speculative ones.

The builder's image-token alignment at load is here too.
"""

import argparse
import base64
import builtins
import dataclasses
import http.client
import io
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from conftest import MockTokenizer
from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu_torch.data import image_pipeline as tpipe
from vis_zephyr_tpu_torch.models import builder as tbuilder
from vis_zephyr_tpu_torch.serve import api as tapi
from vis_zephyr_tpu_torch.serve import cli as tcli
from vis_zephyr_tpu_torch.serve import engine as tengine
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)
# The same model with a 16-token sliding window (cache_len 64 > window, so
# the paged kernels mask and skip pages).
WCFG = dataclasses.replace(CFG, decoder=dataclasses.replace(CFG.decoder, sliding_window=16))
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    params = jax_params_numpy(CFG, 1)
    return params, port_model(params, CFG)


@pytest.fixture(scope="module")
def image():
    pixels = np.random.default_rng(0).integers(0, 255, (60, 80, 3), dtype=np.uint8)
    return Image.fromarray(pixels)


# -- prompt lookup ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_propose_lookup_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 3, 7, 30, 90):
        history = rng.integers(0, 4 + seed, n)  # a small vocabulary: many matches
        for ngram in (1, 2, 3):
            for span in (1, 4, 8):
                got = tgen._propose_lookup(history, ngram=ngram, span=span)
                want = jgen._propose_lookup(history, ngram=ngram, span=span)
                assert (got is None) == (want is None), (n, ngram, span)
                if want is not None:
                    np.testing.assert_array_equal(got, want)
    assert tgen._propose_lookup(np.array([5, 6, 7, 5, 6]), span=4).tolist() == [7, 5, 6]


# -- the dense path --------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [3, 7, 50])
def test_lookup_history_proposes_what_propose_lookup_does(vocab):
    rng = np.random.default_rng(vocab)
    tokens = rng.integers(0, vocab, 300).tolist()
    history = tgen.LookupHistory()
    for n, tok in enumerate(tokens, 1):
        history.append(tok)
        assert list(history) == tokens[:n] and np.asarray(history).tolist() == tokens[:n]
        for span in (1, 4, 8):
            want = tgen._propose_lookup(np.asarray(tokens[:n]), span=span)
            got = history.propose(span)
            assert (got is None) == (want is None), (n, span)
            if want is not None:
                assert got.tolist() == want.tolist() and len(got) > 0, (n, span)


def test_decode_verify_logits_match_jax(models):
    """A prefilled text prompt, then one verify of the pending token, two
    proposals and two padded columns."""
    params, port = models
    ids = np.array([[1, 5, 9, 11, 13, 17, 19, 23, 29]], np.int64)
    toks = np.array([[31, 37, 41, 0, 0]], np.int64)
    valid = np.array([[True, True, True, False, False]])
    _, jcache, _ = jgen.prefill(params, jnp.asarray(ids), None, None, CFG, 64)
    want, jnew = jgen.decode_verify(params, jcache, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(valid), CFG)
    _, tcache, _ = tgen.prefill(port, torch.from_numpy(ids), None, None, TCFG, 64)
    before = tgen.verify_calls
    got, tnew = tgen.decode_verify(port, tcache, torch.from_numpy(toks), torch.from_numpy(valid),
                                   TCFG)
    assert tgen.verify_calls == before + 1
    assert got.shape == (1, 5, CFG.decoder.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int(tnew["length"][0]) == int(jnew["length"][0]) == ids.shape[1] + 3


def stream_requests(image):
    """(name, ids, pixels, valid, lookahead, max_new_tokens)."""
    rng = np.random.default_rng(3)
    text = rng.integers(5, CFG.decoder.vocab_size, (1, 12))
    repetitive = np.tile(np.array([[7, 19, 23, 5, 42]]), (1, 5))
    pixels, valid = tpipe.anyres_preprocess_host(image, CFG.mm_grid_pinpoints,
                                                 CFG.vision.image_size)
    with_image = np.array([[1, 5, IMAGE_TOKEN_INDEX, 7, 9, 11, 7, 9]])
    return {"text": (text, None, None, 4, 12),
            "repetitive": (repetitive, None, None, 6, 16),
            "image": (with_image, pixels[None], valid[None], 4, 12)}


@pytest.mark.parametrize("name", ["text", "repetitive", "image"])
def test_generate_stream_lookahead_matches_jax_and_plain(models, image, name):
    params, port = models
    ids, pixels, valid, lookahead, max_new = stream_requests(image)[name]
    ids = ids.astype(np.int64)
    sampling = dict(max_new_tokens=max_new, eos_token_id=-1)
    want = list(jgen.generate_stream(
        params, jnp.asarray(ids), None if pixels is None else jnp.asarray(pixels),
        None if valid is None else jnp.asarray(valid), CFG, jgen.SamplingConfig(**sampling),
        lookahead=lookahead))
    args = (port, torch.from_numpy(ids), None if pixels is None else torch.from_numpy(pixels),
            None if valid is None else torch.from_numpy(valid), TCFG,
            tgen.SamplingConfig(**sampling))
    tgen.verify_calls = tgen.proposed = tgen.accepted = 0
    got = list(tgen.generate_stream(*args, lookahead=lookahead))
    calls, accepted = tgen.verify_calls, tgen.accepted
    plain = list(tgen.generate_stream(*args))
    assert got == want == plain and len(got) == max_new
    assert 0 < calls <= max_new - 1
    if name == "repetitive":  # the copy structure is found and accepted
        assert accepted > 0 and calls < max_new - 1


def test_generate_stream_speculates_on_the_fixed_cache_it_is_given(models, image, monkeypatch):
    """`generate_stream(lookahead=k)` prefills and verifies on the cache that
    `burst_cache` hands it (on the card the model's one fixed cache, which a
    captured verify step reads; here one made for the test, which the CPU
    runs eagerly), request after request, rows of the one before left in
    it, with the JAX speculative stream's tokens."""
    params, port = models
    ids, _, _, lookahead, max_new = stream_requests(image)["repetitive"]
    ids = ids.astype(np.int64)
    sampling = dict(max_new_tokens=max_new, eos_token_id=-1)
    want = list(jgen.generate_stream(params, jnp.asarray(ids), None, None, CFG,
                                     jgen.SamplingConfig(**sampling), lookahead=lookahead))
    fixed = tgen.init_cache(TCFG.decoder, 1, 256, dtype=port.dtype)
    graphs = tgen.StepGraphs()
    given = []
    monkeypatch.setattr(tgen, "burst_cache",
                        lambda model, cfg, batch, cache_len, like: given.append(cache_len)
                        or (fixed, graphs))
    seen = []
    verify = tgen.decode_verify
    monkeypatch.setattr(tgen, "decode_verify", lambda model, cache, *a: seen.append(
        tuple(cache[name].data_ptr() for name in ("k", "v", "length"))) or verify(model, cache,
                                                                                   *a))
    ptrs = tuple(fixed[name].data_ptr() for name in ("k", "v", "length"))
    for _ in range(2):
        got = list(tgen.generate_stream(port, torch.from_numpy(ids), None, None, TCFG,
                                        tgen.SamplingConfig(**sampling), lookahead=lookahead))
        assert got == want and len(got) == max_new
    assert len(given) == 2 and max(given) <= 256
    assert len(seen) >= 4 and set(seen) == {ptrs}


def test_generate_stream_ignores_lookahead_when_sampling(models):
    """Speculation is greedy only: with temperature > 0 the plain loop runs."""
    _, port = models
    ids = torch.tensor([[1, 5, 9, 5, 9, 5, 9]])
    sampling = tgen.SamplingConfig(max_new_tokens=6, temperature=0.8, eos_token_id=-1)
    tgen.verify_calls = 0
    draws = [list(tgen.generate_stream(port, ids, None, None, TCFG, sampling,
                                       torch.Generator().manual_seed(4), lookahead=lookahead))
             for lookahead in (0, 3)]
    assert draws[0] == draws[1] and tgen.verify_calls == 0


# -- the paged batcher -----------------------------------------------------------------

# (config, kv_quant, kv_fused, prefill_chunk). The first is held against the
# JAX batcher too (its jit compiles cost some 10 s a configuration); the
# other against the port's own lookahead 0.
PAGED = {"int8-fused-chunked-window": (WCFG, True, True, 16),
         "f32-split-whole": (CFG, False, False, None)}


@pytest.fixture(scope="module")
def window_models():
    params = jax_params_numpy(WCFG, 1)
    return params, port_model(params, WCFG)


def paged_requests(image):
    """(ids, pixels, valid, max_new_tokens): repetitive prompts (lookup finds
    matches), a random one, an image, and one whose prompt and budget fill
    the 64-token cache exactly (its last verify spans run into padding past
    `cache_len`)."""
    rng = np.random.default_rng(8)
    pixels, valid = tpipe.anyres_preprocess_host(image, CFG.mm_grid_pinpoints,
                                                 CFG.vision.image_size)
    with_image = np.array([1, 5, IMAGE_TOKEN_INDEX, 7, 9, 11, 7, 9, 11])
    return [(np.tile(rng.integers(5, 60, (6,)), 3), None, None, 14),
            (rng.integers(5, 250, (9,)), None, None, 10),
            (with_image, pixels, valid, 12),
            (np.tile(rng.integers(5, 40, (5,)), 8), None, None, 24)]


def run_paged(batcher, requests):
    handles = [batcher.submit(ids.astype(np.int64), px, pv, max_new_tokens=n)
               for ids, px, pv, n in requests]
    batcher.run_until_drained()
    assert not batcher.active.any()
    return [list(batcher.stream(h)) for h in handles]


@pytest.mark.parametrize("name", list(PAGED))
def test_paged_batcher_lookahead_matches_jax_and_plain(models, window_models, image, name):
    cfg, quant, fused, chunk = PAGED[name]
    params, port = window_models if cfg is WCFG else models
    tcfg = port_config(cfg)
    requests = paged_requests(image)
    assert len(requests[-1][0]) + requests[-1][3] == 64  # fills cache_len
    kw = dict(max_slots=3, cache_len=64, page_size=16, num_pages=14, kv_quant=quant,
              kv_fused=fused, prefill_chunk=chunk)
    spec = tpaged.PagedBatcher(port, tcfg, sampling=tgen.SamplingConfig(
        max_new_tokens=16, eos_token_id=-1), lookahead=4, **kw)
    got = run_paged(spec, requests)
    plain = run_paged(tpaged.PagedBatcher(port, tcfg, sampling=tgen.SamplingConfig(
        max_new_tokens=16, eos_token_id=-1), **kw), requests)
    assert got == plain
    if name == "int8-fused-chunked-window":
        want = run_paged(jpaged.PagedBatcher(
            params, cfg, sampling=jgen.SamplingConfig(max_new_tokens=16, eos_token_id=-1),
            lookahead=4, **kw), requests)
        assert got == want
    assert [len(r) for r in got] == [n for *_, n in requests]
    assert spec.verify_steps > 0 and spec.accepted > 0 and spec.steps == 0
    assert spec.allocator.available == kw["num_pages"] - 1  # every page came back
    assert not spec.page_table.any()


def test_paged_batcher_verify_step_counts_and_headroom(models):
    """Speculation is greedy only (a sampling batcher runs decode steps), and
    multi-step is ignored under it; one verify step reaches every active slot."""
    _, port = models
    kw = dict(max_slots=2, cache_len=64, page_size=16, num_pages=10)
    sampled = tpaged.PagedBatcher(port, TCFG, sampling=tgen.SamplingConfig(
        max_new_tokens=4, temperature=0.7), lookahead=4, **kw)
    assert sampled.lookahead == 0 and sampled._headroom == 1
    b = tpaged.PagedBatcher(port, TCFG, sampling=tgen.SamplingConfig(
        max_new_tokens=8, eos_token_id=-1), lookahead=3, multi_step=4, **kw)
    assert b._headroom == 4
    ids = np.tile(np.array([5, 6, 7]), 4)
    handles = [b.submit(ids), b.submit(ids[:7])]
    b.step()
    assert b.verify_steps == 1 and b.steps == 0 and b.last_logits.shape[:2] == (2, 4)
    assert b.lengths.tolist() == b.slot_len.tolist()
    b.run_until_drained()
    assert [len(list(b.stream(h))) for h in handles] == [8, 8]


def test_paged_batcher_verify_steps_run_through_fixed_buffers(models, image, monkeypatch):
    """Every verify step of a batcher reads its candidates and `active` from
    the same two tensors (`verify_buffers`, filled by copies) and runs on
    the batcher's step graphs: on the card a captured step replays over
    them. The tokens are the batcher's without speculation (and the JAX
    batcher's: `test_paged_batcher_lookahead_matches_jax_and_plain`)."""
    _, port = models
    calls = []
    verify = tpaged._paged_verify_step

    def recording(model, kp, vp, scales, table, lengths, toks, active, cfg, graphs=None):
        calls.append((toks.data_ptr(), active.data_ptr(), graphs, toks.clone(), active.clone()))
        return verify(model, kp, vp, scales, table, lengths, toks, active, cfg, graphs)

    monkeypatch.setattr(tpaged, "_paged_verify_step", recording)
    kw = dict(max_slots=3, cache_len=64, page_size=16, num_pages=14)
    sampling = tgen.SamplingConfig(max_new_tokens=16, eos_token_id=-1)
    spec = tpaged.PagedBatcher(port, TCFG, sampling=sampling, lookahead=4, **kw)
    requests = paged_requests(image)[:2]
    got = run_paged(spec, requests)
    toks_buf, active_buf = spec.verify_buffers(5)
    assert len(calls) == spec.verify_steps >= 2
    assert {c[:3] for c in calls} == {(toks_buf.data_ptr(), active_buf.data_ptr(), spec.graphs)}
    assert tuple(toks_buf.shape) == (3, 5) and toks_buf.dtype == torch.int64
    assert any(not torch.equal(a[3], b[3]) for a, b in zip(calls, calls[1:]))  # filled anew
    assert calls[0][4].tolist() == [True, True, False]
    assert got == run_paged(tpaged.PagedBatcher(port, TCFG, sampling=sampling, **kw), requests)


# -- the flag through the CLI and the server -------------------------------------------


def test_lookahead_flag_through_cli_and_server(models, image, tmp_path, monkeypatch, capsys):
    _, port = models
    want = tengine.ChatEngine(port, TCFG, MockTokenizer(), max_new_tokens=6).chat_text(
        "s", "describe the picture", pil_image=image)
    assert want

    # The CLI: the serialized path with --lookahead.
    engines = []

    class Recording(tengine.ChatEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            engines.append(self)

    image_file = tmp_path / "demo.png"
    image.save(image_file)
    monkeypatch.setattr(tcli, "load_pretrained_model",
                        lambda *a, **kw: (MockTokenizer(), port, TCFG, 512))
    monkeypatch.setattr(tcli, "ChatEngine", Recording)
    turns = iter(["describe the picture"])

    def answer(prompt=""):
        try:
            return next(turns)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr(builtins, "input", answer)
    tcli.main(["--model-path", str(tmp_path), "--image-file", str(image_file),
               "--max-new-tokens", "6", "--lookahead", "3"])
    assert engines[0].lookahead == 3 and engines[0].batcher is None
    assert f"assistant: {want}\n" in capsys.readouterr().out

    # The server: the paged batcher with --lookahead.
    parser = argparse.ArgumentParser()
    tapi.add_engine_args(parser)
    flags = parser.parse_args(["--continuous-batching", "--kv-cache", "paged", "--kv-quant",
                               "--max-slots", "2", "--page-size", "16", "--max-new-tokens", "6",
                               "--lookahead", "3"])
    assert parser.parse_args([]).lookahead == 0
    engine = tapi.engine_from_args(port, TCFG, MockTokenizer(), flags)
    assert engine.batcher.lookahead == 3
    server = tapi.serve(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        image.save(buf, format="PNG")
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        conn.request("POST", "/chat", body=json.dumps({
            "session_id": "s", "question": "describe the picture",
            "image_base64": base64.b64encode(buf.getvalue()).decode()}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        reply = (resp.status, resp.read().decode())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        engine.close()
    assert reply == (200, want)
    assert engine.batcher.verify_steps > 0


# -- the builder -----------------------------------------------------------------------


@pytest.mark.parametrize("flag", ["mm_use_im_start_end", "mm_use_im_patch_token"])
def test_builder_refuses_image_token_alignment_before_reading_weights(tmp_path, flag,
                                                                     monkeypatch, models):
    """The builder no longer refuses these flags: as the JAX builder does, it
    adds the image tokens to the tokenizer and mean-extends the embedding
    and output tables at load, with HF's tokenizer in place of the native
    one (which has no added-token machinery), and the returned config's
    vocabulary follows the tables (tests/test_torch_load.py holds the
    alignment against JAX). The name is kept from when the builder refused
    them."""
    from torch_port_util import word_list, word_tokenizer

    _, port = models
    base, tower = tmp_path / "base", tmp_path / "tower"
    for d in (base, tower):
        d.mkdir()
    torch.save(port.decoder.state_dict(), base / "pytorch_model.bin")
    torch.save({f"vision_model.{k}": v for k, v in port.vision.state_dict().items()},
               tower / "pytorch_model.bin")
    torch.save({f"model.mm_projector.{k}": v for k, v in port.projector.state_dict().items()},
               tmp_path / "mm_projector.bin")
    (tmp_path / "config.json").write_text(dataclasses.replace(CFG, **{flag: True}).to_json())
    word_tokenizer(word_list(CFG.decoder.vocab_size)).save_pretrained(str(base))
    monkeypatch.setenv("VZT_NATIVE_TOKENIZER", "1")
    tok, loaded, cfg, _ = tbuilder.load_pretrained_model(
        str(tmp_path), model_base=str(base), vision_tower_path=str(tower),
        dtype=torch.float32, device="cpu")
    n = 2 if flag == "mm_use_im_start_end" else 1
    V = CFG.decoder.vocab_size + n
    assert type(tok).__name__ == "PreTrainedTokenizerFast" and len(tok) == V
    assert getattr(cfg, flag) and cfg.decoder.vocab_size == V
    for table in (loaded.decoder.model.embed_tokens.weight, loaded.decoder.lm_head.weight):
        assert table.shape[0] == V
        torch.testing.assert_close(table[-n:], table[:-n].mean(0, keepdim=True).expand(n, -1),
                                   rtol=0, atol=0)
