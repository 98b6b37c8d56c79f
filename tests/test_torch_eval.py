"""The port's evaluation entry point against the JAX package's, on the CPU.

`extract_answer` and `get_chunk` on the JAX tests' golden cases; the port's
`beam_search` against the JAX `beam_search` at `tiny_config` in f32 on the
same weights (the weight bridge): identical tokens at K = 1, 2 and 4, at a
`length_penalty` other than 1, and with lm_head's EOS row raised so that
EOS candidates retire; the fixed-cache route the card takes (the B = 1
prefill expanded into a K-row cache and the parents' rows reordered in
place, `_beam_expand` / `_beam_reorder` with `rows`), run here with its
captured step run eagerly, against the gathered route bit for bit; the VCR
harness's `eval_model` against the JAX one on 3 synthetic items at batch 2,
greedy and with `--num-beams 2` (identical answers JSONL); the retry path's
random substitute; and `eval_mmbench` end to end on a 3-row TSV of base64
PNGs. Tokens and JSONL lines are compared exactly: no tolerance is used.
"""

import base64
import copy
import csv
import io
import json
import random

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from conftest import MockTokenizer
from torch_port_util import jax_params_numpy, port_config, port_model, vcr_records
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.eval import answer_extraction as jextract
from vis_zephyr_tpu.eval import eval_mmbench as jmmbench
from vis_zephyr_tpu.eval import eval_vqa as jvqa
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu_torch.eval import answer_extraction as textract
from vis_zephyr_tpu_torch.eval import eval_mmbench as tmmbench
from vis_zephyr_tpu_torch.eval import eval_vqa as tvqa
from vis_zephyr_tpu_torch.models.mistral import init_cache
from vis_zephyr_tpu_torch.serve import generate as tgen

CFG = tiny_config(vocab_size=1024)  # room for the mock tokenizer's ids
TCFG = port_config(CFG)
PROMPTS = ([1, 17, 23, 42, 7, 300], [1, 9, 200, 77])
EOS = CFG.decoder.eos_token_id


@pytest.fixture(scope="module")
def params():
    return jax_params_numpy(CFG, 0)


@pytest.fixture(scope="module")
def models(params):
    """(JAX params as device arrays, the port's f32 model) of one init."""
    return jax.tree_util.tree_map(jax.numpy.asarray, params), port_model(params, CFG)


@pytest.mark.parametrize("text,expected", [
    ("The answer is (B) because...", "B"),
    ("Answer is: C.", "C"),
    ("A", "A"),
    ("D. The person is smiling", "D"),
    ("I think the answer here. It is B.", "B"),
    ("nothing useful at all", "A"),  # default
    ("BCD words. Then (C) appears.", "C"),
    ("b lowercase doesn't count", "A"),
])
def test_extract_answer_golden(text, expected):
    assert textract.extract_answer(text) == expected == jextract.extract_answer(text)


def test_chunking_matches():
    for n in (0, 1, 7, 10, 23):
        items = list(range(n))
        for chunks in (1, 2, 3, 4):
            got = textract.split_chunks(items, chunks) if n else []
            want = jextract.split_chunks(items, chunks) if n else []
            assert got == want and sum(got, []) == items
            for i in range(len(want)):
                assert textract.get_chunk(items, chunks, i) == jextract.get_chunk(items, chunks, i)
    assert textract.get_chunk(list(range(10)), 4, 0) == [0, 1, 2]


def beams_both(jparams, model, prompt, **kw):
    """The JAX and the port's `beam_search` tokens for a text prompt."""
    want = jgen.beam_search(jparams, jax.numpy.asarray([prompt]), None, None, CFG, **kw)
    got = tgen.beam_search(model, torch.tensor([prompt]), None, None, TCFG, **kw)
    return got, want


@pytest.mark.parametrize("num_beams", [1, 2, 4])
def test_beam_search_matches_jax(models, num_beams):
    jparams, model = models
    for prompt in PROMPTS:
        got, want = beams_both(jparams, model, prompt, num_beams=num_beams, max_new_tokens=6,
                               eos_token_id=-1)
        assert got == want and len(got) == 6, (prompt, got, want)
    if num_beams == 1:  # one beam is greedy decoding
        sampling = tgen.SamplingConfig(max_new_tokens=6, eos_token_id=-1)
        greedy = list(tgen.generate_stream(model, torch.tensor([PROMPTS[0]]), None, None, TCFG,
                                           sampling))
        assert tgen.beam_search(model, torch.tensor([PROMPTS[0]]), None, None, TCFG, num_beams=1,
                                max_new_tokens=6, eos_token_id=-1) == greedy


def test_beam_search_length_penalty_matches_jax(models):
    jparams, model = models
    for penalty in (0.5, 2.0):
        got, want = beams_both(jparams, model, PROMPTS[1], num_beams=3, max_new_tokens=5,
                               eos_token_id=EOS, length_penalty=penalty)
        assert got == want, (penalty, got, want)


@pytest.fixture(scope="module")
def eos_raised(params):
    """Weights whose lm_head EOS column is the greedy second token's, scaled
    by 1.05: EOS leads wherever that token did, so beams retire."""
    model = port_model(params, CFG)
    sampling = tgen.SamplingConfig(max_new_tokens=3, eos_token_id=-1)
    second = list(tgen.generate_stream(model, torch.tensor([PROMPTS[0]]), None, None, TCFG,
                                       sampling))[1]
    raised = copy.deepcopy(params)
    kernel = raised["decoder"]["lm_head"]["kernel"]
    kernel[:, EOS] = 1.05 * kernel[:, second]
    return jax.tree_util.tree_map(jax.numpy.asarray, raised), port_model(raised, CFG)


@pytest.mark.parametrize("num_beams", [2, 4])
def test_beam_search_eos_retires_as_jax(eos_raised, num_beams):
    jparams, model = eos_raised
    for prompt in PROMPTS:
        got, want = beams_both(jparams, model, prompt, num_beams=num_beams, max_new_tokens=8,
                               eos_token_id=EOS)
        assert got == want and EOS not in got, (prompt, got, want)
    pool = tgen.beam_hypotheses(model, torch.tensor([PROMPTS[0]]), None, None, TCFG,
                                num_beams=num_beams, max_new_tokens=8, eos_token_id=EOS)
    assert any(len(seq) < 8 for _, seq in pool), pool  # a beam retired at EOS


class EagerGraphs:
    """`StepGraphs`' surface with the step run eagerly at every call: the
    card's fixed-cache route of `beam_hypotheses`, on the CPU."""

    def __init__(self):
        self._buffers, self.runs = {}, 0

    def buffers(self, key, make):
        return self._buffers.setdefault(key, make())

    def run(self, key, step, device, generator=None):
        self.runs += 1
        return step()


@pytest.mark.parametrize("num_beams", [2, 4])
def test_fixed_cache_beams_equal_gathered(monkeypatch, eos_raised, num_beams):
    """The fixed-cache route (stale rows from an earlier request past every
    beam's length, in a cache of more slots than asked) against the eager
    route on the same cache size: the same finished pool, scores bit for
    bit, and the same tokens with EOS retiring."""
    _, model = eos_raised
    ids = torch.tensor([PROMPTS[0]])
    slots = 256
    fixed = init_cache(TCFG.decoder, num_beams, slots, dtype=torch.float32)
    fixed["k"].normal_(generator=torch.Generator().manual_seed(1))
    fixed["v"].normal_(generator=torch.Generator().manual_seed(2))
    graphs = EagerGraphs()
    monkeypatch.setattr(tgen, "burst_cache", lambda *a: (fixed, graphs))
    stats = {}
    got = tgen.beam_hypotheses(model, ids, None, None, TCFG, num_beams=num_beams,
                               max_new_tokens=8, eos_token_id=EOS, stats=stats)
    want = tgen.beam_hypotheses(model, ids, None, None, TCFG, num_beams=num_beams,
                                max_new_tokens=8, eos_token_id=EOS, cache_len=slots, eager=True)
    assert got == want
    assert graphs.runs == stats["steps"] >= len(stats["step_s"]) > 0
    assert int(fixed["length"][0]) == len(PROMPTS[0]) + graphs.runs
    assert torch.equal(fixed["length"], fixed["length"][:1].expand(num_beams))


def test_beam_expand_and_reorder_in_place():
    """`_beam_expand` / `_beam_reorder` with `rows` write, in place, what the
    gathering forms return, on every slot below `rows`."""
    gen = torch.Generator().manual_seed(0)
    one = {"k": torch.randn(2, 1, 16, 2, 4, generator=gen),
           "v": torch.randn(2, 1, 16, 2, 4, generator=gen),
           "length": torch.tensor([5], dtype=torch.int32)}
    want = tgen._beam_expand(one, 4)
    fixed = {"k": torch.randn(2, 4, 16, 2, 4, generator=gen),
             "v": torch.randn(2, 4, 16, 2, 4, generator=gen),
             "length": torch.tensor([5, 0, 9, 3], dtype=torch.int32)}
    fixed["k"][:, :1], fixed["v"][:, :1] = one["k"], one["v"]
    assert tgen._beam_expand(fixed, 4, rows=5) is fixed
    for name in ("k", "v"):
        assert torch.equal(fixed[name][:, :, :5], want[name][:, :, :5])
    assert torch.equal(fixed["length"], want["length"])
    for parents in ([0, 1, 2, 3], [2, 2, 0, 1], [3, 3, 3, 3]):
        fixed["k"][:, :, :7].normal_(generator=gen)
        gathered = tgen._beam_reorder(fixed, parents)
        tgen._beam_reorder(fixed, parents, rows=7)
        for name in ("k", "v"):
            assert torch.equal(fixed[name][:, :, :7], gathered[name][:, :, :7]), parents
        assert torch.equal(fixed["length"], gathered["length"])


def vqa_args(mod, records_path, folder, answers, num_beams, batch_size=2):
    return mod.build_parser().parse_args([
        "--question-file", str(records_path), "--image-folder", folder,
        "--answers-file", str(answers), "--visual-prompt-style", "vcr_qa",
        "--batch-size", str(batch_size), "--max-new-tokens", "4",
        "--num-beams", str(num_beams), "--seed", "5"])


@pytest.fixture(scope="module")
def vcr(tmp_path_factory):
    root = tmp_path_factory.mktemp("vcr")
    records, folder = vcr_records(root, 3, seed=1)
    path = root / "questions.json"
    path.write_text(json.dumps(records))
    return records, folder, path


@pytest.mark.parametrize("num_beams", [1, 2])
def test_eval_vqa_matches_jax(models, vcr, tmp_path, num_beams):
    """3 items at batch 2 (a batch of 2, then a last batch of 1): the two
    harnesses' answers JSONL line for line, and their (correct, total)."""
    jparams, model = models
    _, folder, path = vcr
    runs = []
    for mod, weights, kw in ((jvqa, jparams, "params"), (tvqa, model, "model")):
        answers = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        tok = MockTokenizer()
        result = mod.eval_model(vqa_args(mod, path, folder, answers, num_beams),
                                **{kw: weights}, cfg=CFG if mod is jvqa else TCFG,
                                tokenizer=tok)
        assert max(tok.vocab.values()) < CFG.decoder.vocab_size
        runs.append((result, answers.read_text().splitlines()))
    assert runs[1] == runs[0]
    assert len(runs[1][1]) == 3 and runs[1][0][1] == 3
    lines = [json.loads(line) for line in runs[1][1]]
    assert [line["question_id"] for line in lines] == ["q0", "q1", "q2"]
    assert all("Answer with the option's letter" in line["prompt"] for line in lines)


def test_retry_substitutes_as_jax(vcr, tmp_path):
    """An item whose `meta_dir` is broken fails its 10 attempts and is
    replaced by a random other item, drawn from the same generator: the
    same substitute, prompt and pixels in both packages."""
    records, folder, _ = vcr
    broken = copy.deepcopy(records)
    broken[1]["meta_dir"] = "./dataset/missing.json"
    got = []
    for mod, cfg in ((jvqa, CFG), (tvqa, TCFG)):
        rng = random.Random(7)
        items = [mod.prepare_item_with_retry(broken, i, folder, cfg, MockTokenizer(), "vcr_qa",
                                             rng) for i in range(3)]
        got.append((items, rng.random()))
    (want, want_next), (items, items_next) = got
    assert items_next == want_next
    for a, b in zip(items, want):
        assert a["question_id"] == b["question_id"] and a["prompt"] == b["prompt"]
        assert a["gold"] == b["gold"]
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["patch_valid"], b["patch_valid"])
    assert items[1]["question_id"] != "q1"


def test_eval_mmbench_matches_jax(models, tmp_path):
    jparams, model = models
    rng = np.random.default_rng(2)
    tsv = tmp_path / "mmbench.tsv"
    rows = [{"index": 0, "question": "What color?", "hint": "Look closely",
             "A": "red", "B": "blue", "C": "green", "D": "grey", "answer": "B"},
            {"index": 1, "question": "How many?", "hint": "", "A": "one", "B": "two",
             "C": "three", "D": "four", "answer": "A"},
            {"index": 2, "question": "Which side?", "hint": "nan", "A": "left",
             "B": "right", "C": "", "D": "", "answer": ""}]
    with open(tsv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["index", "question", "hint", "A", "B", "C", "D",
                                          "answer", "image"], delimiter="\t")
        w.writeheader()
        for i, row in enumerate(rows):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 255, (60 + 10 * i, 90, 3), np.uint8)).save(
                buf, format="PNG")
            w.writerow(dict(row, image=base64.b64encode(buf.getvalue()).decode()))
    runs = []
    for mod, weights, kw in ((jmmbench, jparams, "params"), (tmmbench, model, "model")):
        answers = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        args = mod.build_parser().parse_args([
            "--question-file", str(tsv), "--answers-file", str(answers),
            "--batch-size", "2", "--max-new-tokens", "4"])
        result = mod.eval_model(args, **{kw: weights}, cfg=CFG if mod is jmmbench else TCFG,
                                tokenizer=MockTokenizer())
        runs.append((result, answers.read_text().splitlines()))
    assert runs[1] == runs[0]
    assert runs[1][0][1:] == (2, 3)  # two rows with a gold answer, three rows
    assert "Look closely" in json.loads(runs[1][1][0])["prompt"]
    assert tmmbench.build_prompt(rows[2]).count("\n") == 4  # no hint, no C or D


def test_device_flag_defaults_to_the_card():
    for mod in (tvqa, tmmbench):
        args = mod.build_parser().parse_args(["--question-file", "q", "--image-folder", "i"]
                                             if mod is tvqa else ["--question-file", "q"])
        assert args.device == "cuda"
