"""The port stands alone: it imports neither `jax` nor the JAX package.

A fresh interpreter, with both blocked by an import hook, imports every module
of `vis_zephyr_tpu_torch` (the ported experiment probes among them, whose
numerics checks it runs) and serves a chat through a serialized, a dense-batching
and a paged `ChatEngine` on the CPU, with float and with int8 weights, a chat
under a multi-LoRA adapter (`ops/mlora.py`) on int8 weights, and an
OpenAI chat completion with logprobs and penalties, a chat on each batcher
with a draft model and `ServingMetrics`, then drains, and takes one stage-1 and
one stage-2 train step, whose state the builder serves back through the
native tokenizer; a source scan finds no such import in the port or in
`chip_smoke.py`. The modules the port copied instead of importing
(`config`, `constants`, `conversation`, `data/anyres`, `data/tokenization`,
the sampler of `data/dataset`, `MetricsLogger` and `ServingMetrics`,
`StopMatcher` and the vocabulary's byte
strings of the OpenAI endpoints, `data/tokenizer_native` and `data/native`)
give what the JAX package's give on the same inputs; the port builds its
native libraries into its own build directory, never into `native/`.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import pytest

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
import vis_zephyr_tpu.config as jconfig
import vis_zephyr_tpu.constants as jconstants
import vis_zephyr_tpu.conversation as jconversation
import vis_zephyr_tpu.data.anyres as janyres
import vis_zephyr_tpu.data.dataset as jdataset
import vis_zephyr_tpu.data.tokenization as jtokenization
import vis_zephyr_tpu_torch.config as tconfig
import vis_zephyr_tpu_torch.constants as tconstants
import vis_zephyr_tpu_torch.conversation as tconversation
import vis_zephyr_tpu_torch.data.anyres as tanyres
import vis_zephyr_tpu_torch.data.dataset as tdataset
import vis_zephyr_tpu_torch.data.tokenization as ttokenization
from conftest import MockTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_RUN = r"""
import importlib, importlib.abc, pkgutil, sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "vis_zephyr_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())

import numpy as np
import torch
import vis_zephyr_tpu_torch

torch.set_num_threads(1)  # one of several test workers on a few cores
names = [m.name for m in pkgutil.walk_packages(vis_zephyr_tpu_torch.__path__,
                                               "vis_zephyr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 25, names
assert "vis_zephyr_tpu_torch.ops.mlora" in names, names
for probe in ("fused_mlp_matvec_probe", "batched_paged_attention_probe",
              "paired_slot_attention_probe"):
    assert f"vis_zephyr_tpu_torch.experiments.{probe}" in names, names

# The fused int8 MLP probe's numerics check, at small widths on the CPU.
import contextlib, io
from vis_zephyr_tpu_torch.experiments.fused_mlp_matvec_probe import main as probe_main

with contextlib.redirect_stdout(io.StringIO()):
    probe = probe_main(["--device", "cpu", "--hidden", "128", "--intermediate", "256"])
assert probe["vs_plain"]["rel_err"] == 0.0, probe

# The attention probes' numerics checks (K10 and K11's plain version on the CPU).
from vis_zephyr_tpu_torch.experiments import batched_paged_attention_probe as batched
from vis_zephyr_tpu_torch.experiments import paired_slot_attention_probe as paired

with contextlib.redirect_stdout(io.StringIO()):
    checks = [batched.main(["--device", "cpu"])]
    checks += [v for k, v in paired.main(["--device", "cpu"]).items() if k.startswith("P")]
assert len(checks) == 4, checks
for check in checks:
    assert check["vs_plain"]["rel_err"] == 0.0 and check["vs_k3"]["rel_err"] <= 1e-2, check

from vis_zephyr_tpu_torch.config import tiny_config
from vis_zephyr_tpu_torch.models.vis_zephyr import init_vis_zephyr
from vis_zephyr_tpu_torch.serve.engine import ChatEngine


class Tokenizer:
    bos_token_id, eos_token_id = 1, 2

    def __call__(self, text):
        return {"input_ids": [1] + [3 + len(w) % 200 for w in text.split()]}

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(f"w{i}" for i in ids)


cfg = tiny_config()
model = init_vis_zephyr(cfg, torch.Generator().manual_seed(0))
pixels = np.zeros((4, 56, 56, 3), np.float32)
valid = np.array([True, True, False, False])
replies = []
for load_8bit in (False, True):
    if load_8bit:
        from vis_zephyr_tpu_torch.models.builder import quantize_weights
        quantize_weights(model)
    for flags in ({}, dict(continuous_batching=True, max_slots=2, cache_len=256,
                           prefill_chunk=32),
                  dict(continuous_batching=True, kv_cache="paged", kv_quant=True,
                       kv_fused=True, max_slots=2, cache_len=256, page_size=16,
                       prefill_chunk=32)):
        engine = ChatEngine(model, cfg, Tokenizer(), max_new_tokens=3, **flags)
        engine.attach_pixels("s", pixels, valid, (112, 56))
        replies.append(engine.chat_text("s", "<image>\nwhat is this"))
        engine.close()
assert len(replies) == 6 and all(len(r.split()) == 3 for r in replies), replies

# Multi-LoRA serving on the int8 weights: two random adapters, one request.
from vis_zephyr_tpu_torch.ops.mlora import make_random_pack

pack = make_random_pack(cfg, 2, 4, torch.Generator().manual_seed(0))
engine = ChatEngine(model, cfg, Tokenizer(), max_new_tokens=3, continuous_batching=True,
                    kv_cache="paged", max_slots=2, cache_len=256, page_size=16, mlora=pack,
                    adapter_names={"a": 1, "b": 2})
engine.attach_pixels("s", pixels, valid, (112, 56))
assert len(engine.chat_text("s", "<image>\nwhat is this", adapter="b").split()) == 3
engine.close()

# An OpenAI chat completion through the dense batcher.
from vis_zephyr_tpu_torch.serve.openai_api import chat_completion

engine = ChatEngine(model, cfg, Tokenizer(), max_new_tokens=3, continuous_batching=True,
                    max_slots=2, cache_len=256)
err, out = chat_completion(engine, {"messages": [{"role": "user", "content": "hi there"}],
                                    "logprobs": True, "top_logprobs": 2,
                                    "presence_penalty": 1.0, "n": 2})
engine.close()
assert err is None and out["usage"]["completion_tokens"] == 6, (err, out)
assert all(len(c["logprobs"]["content"]) == 3 for c in out["choices"]), out

# Two-model speculation with ServingMetrics on both batchers, then a drain.
from vis_zephyr_tpu_torch.serve.engine import EngineDraining
from vis_zephyr_tpu_torch.utils.metrics import ServingMetrics

for cache in ("dense", "paged"):
    metrics = ServingMetrics()
    engine = ChatEngine(model, cfg, Tokenizer(), max_new_tokens=4, continuous_batching=True,
                        kv_cache=cache, max_slots=2, cache_len=256, page_size=16, lookahead=3,
                        draft_model=model, draft_cfg=cfg, metrics=metrics)
    engine.attach_pixels("s", pixels, valid, (112, 56))
    assert len(engine.chat_text("s", "<image>\nwhat is this").split()) == 4
    assert engine.drain(timeout=30) and engine.batcher.draft.admissions == 1
    assert metrics.summary()["requests"] == 1 and metrics.spec_proposed > 0, metrics.summary()
    try:
        engine.chat("s", "again")
        raise AssertionError("a draining engine took a request")
    except EngineDraining:
        pass
    engine.close()

# One stage-1 and one stage-2 train step on the CPU.
from vis_zephyr_tpu_torch.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu_torch.train.lora import LoraConfig, add_lora
from vis_zephyr_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
from vis_zephyr_tpu_torch.train.steps import init_train_state, make_train_step

ids = torch.randint(5, cfg.decoder.vocab_size, (2, 12), generator=torch.Generator().manual_seed(0))
ids[:, 1] = IMAGE_TOKEN_INDEX
batch = {"input_ids": ids, "labels": ids.clone(), "images": torch.zeros(2, 4, 56, 56, 3),
         "patch_valid": torch.tensor([[True, True, False, False]] * 2)}
model = init_vis_zephyr(cfg, torch.Generator().manual_seed(0))
for stage in ("1", "2"):
    if stage == "2":
        add_lora(model, LoraConfig(r=4, alpha=8), torch.Generator().manual_seed(1))
    opt = build_optimizer(model, OptimizerConfig(total_steps=2), stage=stage)
    step = make_train_step(model, cfg, opt, remat=True, lora_dropout=0.05 if stage == "2" else 0.0)
    state, metrics = step(init_train_state(model, opt), batch)
    assert state["step"] == 1 and bool(torch.isfinite(metrics["loss"])), metrics

# The load paths' native routes: the stage-2 state just trained, saved as the
# port's trainer saves it, served back through the builder with the C++ BPE
# tokenizer (VZT_NATIVE_TOKENIZER=1; a Metaspace tokenizer.json written here),
# LoRA merged; and the C++ anyres pipeline where its library builds.
import json, os, tempfile
from vis_zephyr_tpu_torch.data import native, tokenizer_native
from vis_zephyr_tpu_torch.models.builder import load_pretrained_model
from vis_zephyr_tpu_torch.train.checkpoints import save_checkpoint

path = save_checkpoint(tempfile.mkdtemp(), state, step=1)
with open(os.path.join(path, "config.json"), "w") as f:
    f.write(cfg.to_json())
vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, "\u2581": 3, "a": 4, "b": 5, "\u2581a": 6, "\u2581b": 7}
with open(os.path.join(path, "tokenizer.json"), "w") as f:
    json.dump({"model": {"type": "BPE", "vocab": vocab, "merges": ["\u2581 a", "\u2581 b"],
                         "byte_fallback": True},
               "pre_tokenizer": {"type": "Metaspace", "replacement": "\u2581",
                                 "prepend_scheme": "always"}}, f)
os.environ["VZT_NATIVE_TOKENIZER"] = "1"
tok, loaded, _, _ = load_pretrained_model(path, dtype=torch.float32, device="cpu")
assert isinstance(tok, tokenizer_native.NativeTokenizer), tok
assert tok.encode("a b", add_bos=False) == [6, 7] and tok.decode([1, 6, 7]) == "a b"
assert not any(name.endswith("lora_a") for name in loaded.state_dict())
if native.available():
    px, pv = native.anyres_preprocess_native(np.zeros((60, 80, 3), np.uint8),
                                             cfg.mm_grid_pinpoints, target_size=56)
    assert px.shape[1:] == (56, 56, 3) and pv.any()
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "vis_zephyr_tpu")]
print("ok", len(names))
"""


def test_every_port_module_imports_and_serves_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "VZT_PLATFORM"}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("has_image,template", [
    (True, "zephyr_v1"), (False, "zephyr_v1"), (True, "plain")])
def test_training_tokenization_matches(has_image, template):
    tok = MockTokenizer()
    sources = [[{"from": "human", "value": "<image>\nwhat is in the picture"},
                {"from": "gpt", "value": "a cat on a mat"}]]
    if template != "plain":
        sources.append([{"from": "human", "value": "hello there"},
                        {"from": "gpt", "value": "hi"},
                        {"from": "human", "value": "how are you"},
                        {"from": "gpt", "value": "fine thanks"}])
    want = jtokenization.preprocess(sources, tok, has_image=has_image,
                                    conv=jconversation.templates[template])
    got = ttokenization.preprocess(sources, tok, has_image=has_image,
                                   conv=tconversation.templates[template])
    for key in ("input_ids", "labels"):
        assert [x.tolist() for x in got[key]] == [x.tolist() for x in want[key]]
    if template == "plain":
        assert (ttokenization.preprocess_pretrain(sources, tok)["labels"][0].tolist()
                == jtokenization.preprocess_pretrain(sources, tok)["labels"][0].tolist())
    else:  # a mismatch masks everything, in both
        text = "<|user|>\nhi</s>\n<|assistant|>\nyo</s>\n"
        ids = [1, 5, 6, 7]
        assert (ttokenization.mask_labels_zephyr(text, ids, tok, has_image=False).tolist()
                == jtokenization.mask_labels_zephyr(text, ids, tok, has_image=False).tolist())


@pytest.mark.parametrize("group_by_modality,world_size", [(True, 1), (True, 4), (False, 2)])
def test_sampler_order_matches(group_by_modality, world_size):
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = [int(n) * (1 if i % 3 else -1) for i, n in enumerate(rng.integers(1, 400, 53))]
    if not group_by_modality:
        lengths = [abs(n) for n in lengths]
    for epoch in range(2):
        samplers = [mod.LengthGroupedSampler(lengths, batch_size=3, world_size=world_size,
                                             group_by_modality=group_by_modality, seed=7)
                    for mod in (jdataset, tdataset)]
        for s in samplers:
            s.set_epoch(epoch)
        want, got = (list(iter(s)) for s in samplers)
        assert got == want and sorted(got) == list(range(53))
    chunks = [mod.split_to_even_chunks(list(range(12)), [abs(n) for n in lengths], 4)
              for mod in (jdataset, tdataset)]
    assert chunks[0] == chunks[1]


def port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "vis_zephyr_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_source_line_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|vis_zephyr_tpu)(\.|\s|$)")
    files = port_sources()
    assert len(files) >= 25
    for probe in ("fused_mlp_matvec_probe", "batched_paged_attention_probe",
                  "paired_slot_attention_probe"):
        assert os.path.join(REPO, "vis_zephyr_tpu_torch", "experiments", f"{probe}.py") in files
    assert os.path.join(REPO, "vis_zephyr_tpu_torch", "ops", "mlora.py") in files
    hits = [f"{os.path.relpath(path, REPO)}:{n}: {line.strip()}"
            for path in files
            for n, line in enumerate(open(path, encoding="utf-8"), 1) if pattern.match(line)]
    assert not hits, hits


# -- the copied modules against the originals -----------------------------------------


@pytest.mark.parametrize("make", ["VisZephyrConfig", "tiny_config", "smoke_config"])
def test_config_fields_match(make):
    want, got = getattr(jconfig, make)(), getattr(tconfig, make)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()
    assert tconfig.VisZephyrConfig.from_json(want.to_json()) == got
    assert got.tokens_per_patch == want.tokens_per_patch
    assert got.max_extra_merge_tokens() == want.max_extra_merge_tokens()
    unpad = dict(mm_patch_merge_type="spatial_unpad", mm_projector_type="mlp2x_gelu")
    assert (got.replace(**unpad).max_extra_merge_tokens()
            == want.replace(**unpad).max_extra_merge_tokens())
    assert got.replace(**unpad).tokens_per_patch == want.replace(**unpad).tokens_per_patch
    for part in ("vision", "decoder"):
        for prop in ("tokens_per_side", "tokens_per_image", "head_dim"):
            if hasattr(getattr(want, part), prop):
                assert getattr(getattr(got, part), prop) == getattr(getattr(want, part), prop)


STOP_CASES = [
    ([], ["hello ", "world"]),
    (["</s>"], ["abc</", "s>def"]),
    (["END", "STOP"], ["xx EN", "D yy", "STOP"]),
    (["ab"], ["a", "a", "b", "c"]),
    (["xyz"], ["x", "y", "q"]),
]


@pytest.mark.parametrize("stops,deltas", STOP_CASES)
def test_stop_matcher_matches(stops, deltas):
    """`serve/openai_api.py::StopMatcher` is a copy: delta for delta the
    original's output."""
    from vis_zephyr_tpu.serve.openai_api import StopMatcher as JStop
    from vis_zephyr_tpu_torch.serve.openai_api import StopMatcher as TStop

    runs = []
    for cls in (JStop, TStop):
        m = cls(stops)
        runs.append(([m.feed(d) for d in deltas], m.flush(), m.stopped))
    assert runs[0] == runs[1]


def test_metrics_copies_match():
    """`utils/metrics.py`'s `MetricsLogger` and `ServingMetrics` are copies,
    line for line (`tests/test_torch_serving_obs.py` holds their output)."""
    import inspect

    import vis_zephyr_tpu.utils.metrics as jmetrics
    import vis_zephyr_tpu_torch.utils.metrics as tmetrics

    for name in ("MetricsLogger", "ServingMetrics"):
        assert inspect.getsource(getattr(tmetrics, name)) == inspect.getsource(
            getattr(jmetrics, name)), name
    assert tmetrics.ServingMetrics.BUCKETS_MS == jmetrics.ServingMetrics.BUCKETS_MS


def test_token_strings_match():
    """`serve/engine.py::token_strings_from_tokenizer`, the copy of the JAX
    structured module's, on a decode-only tokenizer and on one with
    sentencepiece-style pieces."""
    from vis_zephyr_tpu.serve.structured import token_strings_from_tokenizer as jts
    from vis_zephyr_tpu_torch.serve.engine import token_strings_from_tokenizer as tts

    class Pieces:
        def convert_ids_to_tokens(self, ids):
            table = ["<s>", "\u2581the", "<0xC3>", "ab", None, "\u2581"]
            return [table[i % len(table)] for i in ids]

    tok = MockTokenizer()
    tok("some words to decode")
    assert tts(tok, 20) == jts(tok, 20)
    assert tts(Pieces(), 12) == jts(Pieces(), 12)


def test_constants_match():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert "IMAGE_TOKEN_INDEX" in names and "DEFAULT_IMAGE_TOKEN" in names
    for n in names:
        assert getattr(tconstants, n) == getattr(jconstants, n), n


@pytest.mark.parametrize("name", sorted(jconversation.templates))
def test_conversation_templates_match(name):
    assert sorted(tconversation.templates) == sorted(jconversation.templates)
    want, got = jconversation.templates[name].copy(), tconversation.templates[name].copy()
    for conv in (want, got):
        conv.append_message(conv.roles[0], "<image>\nwhat is in the picture")
        conv.append_message(conv.roles[1], "a cat")
        conv.append_message(conv.roles[0], "what colour")
        conv.append_message(conv.roles[1], None)
    assert got.get_prompt() == want.get_prompt()
    assert got.roles == want.roles and got.messages == want.messages


@pytest.mark.parametrize("prompt", [
    "plain text only", "<image>\ndescribe it", "before <image> after",
    "two <image> images <image> here", "<image>"])
def test_tokenize_with_images_matches(prompt):
    want = jtokenization.tokenize_with_images(prompt, MockTokenizer())
    got = ttokenization.tokenize_with_images(prompt, MockTokenizer())
    assert got == want
    assert got.count(tconstants.IMAGE_TOKEN_INDEX) == prompt.count("<image>")


PINPOINTS = "[[336, 672], [672, 336], [336, 1008], [1008, 336]]"
SIZES = [(640, 480), (500, 321), (2000, 100), (336, 336), (100, 1000), (80, 60)]


@pytest.mark.parametrize("size", SIZES)
def test_anyres_geometry_matches(size):
    pins = tanyres.parse_grid_pinpoints(PINPOINTS)
    assert pins == janyres.parse_grid_pinpoints(PINPOINTS)
    best = tanyres.select_best_fit_resolution(size, pins)
    assert best == janyres.select_best_fit_resolution(size, pins)
    assert tanyres.resize_pad_geometry(size, best) == janyres.resize_pad_geometry(size, best)
    assert tanyres.tile_boxes(best, 336) == janyres.tile_boxes(best, 336)
    assert (tanyres.calculate_grid_shape(size, PINPOINTS, 336)
            == janyres.calculate_grid_shape(size, PINPOINTS, 336))
    assert (tanyres.num_anyres_patches(size, PINPOINTS, 336)
            == janyres.num_anyres_patches(size, PINPOINTS, 336))
    assert tanyres.max_anyres_patches(PINPOINTS, 336) == janyres.max_anyres_patches(PINPOINTS, 336)
    grid = tanyres.calculate_grid_shape(size, PINPOINTS, 336)
    cur = (grid[1] * 24, grid[0] * 24)
    assert tanyres.unpad_slice(cur, size) == janyres.unpad_slice(cur, size)
    assert (tanyres.robust_literal_eval(PINPOINTS) == janyres.robust_literal_eval(PINPOINTS))


# -- the native copies ------------------------------------------------------------------


def _zephyr_like_tokenizer_json(path):
    """A Metaspace + byte-fallback BPE tokenizer.json trained on a few lines."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tok = tokenizers.Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.decoder = decoders.Sequence([decoders.Metaspace(), decoders.ByteFallback(), decoders.Fuse()])
    tok.train_from_iterator(["describe the picture in detail", "what is in the image"] * 20,
                            trainer=trainers.BpeTrainer(vocab_size=120, show_progress=False,
                                                        special_tokens=["<unk>", "<s>", "</s>"]))
    tok.save(str(path))
    tj = json.loads(path.read_text())
    vocab = tj["model"]["vocab"]
    for b in range(256):
        vocab.setdefault(f"<0x{b:02X}>", len(vocab))
    path.write_text(json.dumps(tj))
    return str(path)


def test_native_tokenizer_copy_matches(tmp_path):
    from vis_zephyr_tpu.data import tokenizer_native as jtn
    from vis_zephyr_tpu_torch.data import tokenizer_native as ttn

    path = _zephyr_like_tokenizer_json(tmp_path / "tokenizer.json")
    blob = ttn.convert_tokenizer_json(path)
    assert blob == jtn.convert_tokenizer_json(path)
    if not (ttn.available() and jtn.available()):
        pytest.skip("a native tokenizer library does not build here")
    want, got = jtn.NativeTokenizer(blob=blob), ttn.NativeTokenizer(blob=blob)
    for text in ("describe the picture", "  what's in THE image? é 🙂", ""):
        ids = got.encode(text)
        assert ids == want.encode(text) and got.decode(ids) == want.decode(ids)
    assert got.vocab_size == want.vocab_size


def test_native_image_copy_matches():
    import io

    import numpy as np
    from PIL import Image

    from vis_zephyr_tpu.data import native as jn
    from vis_zephyr_tpu_torch.data import native as tn

    if not (tn.available() and jn.available()):
        pytest.skip("a native image library does not build here")
    img = np.random.default_rng(2).integers(0, 255, (70, 90, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    np.testing.assert_array_equal(tn.decode_jpeg(buf.getvalue()), jn.decode_jpeg(buf.getvalue()))
    np.testing.assert_array_equal(tn.resize_lanczos(img, (50, 40)), jn.resize_lanczos(img, (50, 40)))
    for a, b in zip(tn.anyres_preprocess_native(img, PINPOINTS, target_size=56),
                    jn.anyres_preprocess_native(img, PINPOINTS, target_size=56)):
        np.testing.assert_array_equal(a, b)


def test_port_builds_its_native_libraries_outside_native(tmp_path, monkeypatch):
    """The port reads `native/*.cpp` in place and writes its libraries into
    its own build directory (here a fresh one), never into `native/`."""
    from vis_zephyr_tpu_torch.data import native_lib

    native_dir = os.path.join(REPO, "native")
    assert os.path.realpath(native_lib.NATIVE_DIR) == os.path.realpath(native_dir)
    assert native_lib.BUILD == os.path.join(REPO, "vis_zephyr_tpu_torch", "build")

    def snapshot():
        return {n: os.stat(os.path.join(native_dir, n)).st_mtime_ns for n in os.listdir(native_dir)}

    before = snapshot()
    monkeypatch.setattr(native_lib, "BUILD", str(tmp_path))
    monkeypatch.setattr(native_lib, "_tried", {})
    monkeypatch.setattr(native_lib, "build_error", {})
    built = [native_lib.load("vzt_tokenizer", "vzt_tokenizer.cpp", ["-O3"]),
             native_lib.load("vzt_image", "vzt_image.cpp", ["-O3", "-march=native"], ["-ljpeg"])]
    assert snapshot() == before
    for name, lib in zip(("vzt_tokenizer", "vzt_image"), built):
        assert (lib is not None) == os.path.exists(tmp_path / f"lib{name}.so"), name
        assert lib is not None or native_lib.build_error[name], name
    assert all(n.startswith("lib") and n.endswith(".so") for n in os.listdir(tmp_path))
