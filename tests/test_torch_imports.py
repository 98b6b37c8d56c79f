"""The port stands alone: it imports neither `jax` nor the JAX package.

A fresh interpreter, with both blocked by an import hook, imports every module
of `vis_zephyr_tpu_torch` (the ported experiment probe among them, whose
numerics check it runs) and serves a chat through a serialized and a paged
`ChatEngine` on the CPU, with float and with int8 weights, and takes one
stage-1 and one stage-2 train step; a source scan finds no such import in the
port or in `chip_smoke.py`. The modules the port copied instead of importing
(`config`, `constants`, `conversation`, `data/anyres`, `data/tokenization`,
the sampler of `data/dataset`) give what the JAX package's give on the same
inputs.
"""

import dataclasses
import os
import re
import subprocess
import sys

import pytest

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

names = [m.name for m in pkgutil.walk_packages(vis_zephyr_tpu_torch.__path__,
                                               "vis_zephyr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 25, names
assert "vis_zephyr_tpu_torch.experiments.fused_mlp_matvec_probe" in names, names

# The fused int8 MLP probe's numerics check, at small widths on the CPU.
import contextlib, io
from vis_zephyr_tpu_torch.experiments.fused_mlp_matvec_probe import main as probe_main

with contextlib.redirect_stdout(io.StringIO()):
    probe = probe_main(["--device", "cpu", "--hidden", "128", "--intermediate", "256"])
assert probe["vs_plain"]["rel_err"] == 0.0, probe

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
    for flags in ({}, dict(continuous_batching=True, kv_cache="paged", kv_quant=True,
                           kv_fused=True, max_slots=2, cache_len=256, page_size=16,
                           prefill_chunk=32)):
        engine = ChatEngine(model, cfg, Tokenizer(), max_new_tokens=3, **flags)
        engine.attach_pixels("s", pixels, valid, (112, 56))
        replies.append(engine.chat_text("s", "<image>\nwhat is this"))
        engine.close()
assert len(replies) == 4 and all(len(r.split()) == 3 for r in replies), replies

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
    assert os.path.join(REPO, "vis_zephyr_tpu_torch", "experiments",
                        "fused_mlp_matvec_probe.py") in files
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
