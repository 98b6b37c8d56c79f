"""Grammar-masked decoding on the port's three served paths against the JAX
package's, on the CPU at `tiny_config` in f32.

Both packages run the same weights (through the weight bridge), the same
grammars (the JAX `TokenGrammar` and the port's, built from the token
strings of a word-level HF tokenizer) and one batch: two requests under
each of two grammars of four words and two shorter unconstrained ones, all
admitted at once, so that every JAX decode step is a masked one (the JAX
batchers compile one step program). Greedy tokens equal the JAX
counterpart's per request:

- the serialized `generate_stream` against the JAX `generate_stream`;
- the dense continuous batcher (whole and chunked admission, and with
  multi-step bursts) against the JAX dense batcher;
- the paged batcher on int8 fused pools against the JAX paged batcher of
  the same configuration, and on f32 split pools against the JAX dense
  batcher (f32 pools hold the dense cache's values).

And inside the port: bursts are off while a grammar is active and resume
after, with admissions while grammars are active; the lookahead and draft
refusals carry the JAX message; a lazy allocation swap keeps a slot's DFA
state; the mask buffer keeps its address across steps; unconstrained greedy
rows are what a run without grammars gives, with sampling, penalties,
logprobs, the prefix cache and multi-LoRA beside the grammar slots.
"""

import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import (jax_params_numpy, port_config, port_model, word_list,
                             word_tokenizer)
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.serve import batching as jbatching
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu.serve import structured as js
from vis_zephyr_tpu_torch.serve import batching as tbatching
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged
from vis_zephyr_tpu_torch.serve import structured as ts

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)
WORDS = word_list(256)
EOS = 1  # the word tokenizer's "</s>"
# Grammars of exactly four words over the word vocabulary ("w0".."w251", no
# separators): four of w10..w19; a w2x / w2xx word, then three w3x words.
PATTERNS = ("(w1[0-9]){4}", "w2[0-9]{1,2}(w3[0-9]){3}")
SLOTS, CACHE_LEN, MAX_NEW = 6, 128, 8
PAGED = dict(max_slots=SLOTS, cache_len=64, page_size=16, num_pages=32)


@pytest.fixture(scope="module")
def models():
    params = jax_params_numpy(CFG, 1)
    return params, port_model(params, CFG)


@pytest.fixture(scope="module")
def strings():
    return js.token_strings_from_tokenizer(word_tokenizer(WORDS), CFG.decoder.vocab_size)


@pytest.fixture(scope="module")
def grammars(strings):
    return ([js.TokenGrammar.from_regex(p, strings, EOS) for p in PATTERNS],
            [ts.TokenGrammar.from_regex(p, strings, EOS) for p in PATTERNS])


def scenario(late: bool = False):
    """[(ids, grammar index or None, max_new_tokens, submit before step N)]:
    all at step 0, the free requests done before the constrained ones; with
    `late`, the last two arrive at step 2 and a free request of 12 tokens
    outlives the grammars."""
    rng = np.random.default_rng(3)

    def ids(T):
        return rng.integers(5, CFG.decoder.vocab_size, (T,)).astype(np.int64)

    at = 2 if late else 0
    return [(ids(7), 0, MAX_NEW, 0), (ids(9), None, 12 if late else 3, 0),
            (ids(20), 1, MAX_NEW, 0), (ids(6), None, 2, 0), (ids(8), 0, MAX_NEW, at),
            (ids(11), 1, MAX_NEW, at)]


def drive(batcher, grammars, max_steps=200, reqs=None, **submit):
    """Run `reqs` (the scenario by default) to the end; the tokens a request."""
    handles = {}
    reqs = scenario() if reqs is None else reqs
    for step in range(max_steps):
        for i, (ids, g, max_new, at) in enumerate(reqs):
            if at == step:
                handles[i] = batcher.submit(ids, max_new_tokens=max_new,
                                            grammar=None if g is None else grammars[g], **submit)
        if len(handles) == len(reqs) and not batcher.has_work:
            break
        batcher.step()
    assert not batcher.has_work
    return [list(batcher.stream(handles[i])) for i in range(len(reqs))]


def text(strings, tokens) -> bytes:
    return b"".join(strings[t] for t in tokens)


def check_grammars(got, strings, grammars, reqs=None):
    """Every constrained reply is a whole match of its grammar (four words);
    the unconstrained ones are not all inside either grammar."""
    reqs = scenario() if reqs is None else reqs
    for (_, g, _, _), tokens in zip(reqs, got):
        if g is not None:
            assert len(tokens) == 4 and grammars[g].dfa.matches(text(strings, tokens)), tokens
    free = [text(strings, t) for (_, g, _, _), t in zip(reqs, got) if g is None]
    assert not all(gr.dfa.matches(f) for gr in grammars for f in free)


def jax_sampling(max_new=MAX_NEW):
    return jgen.SamplingConfig(max_new_tokens=max_new, temperature=0.0, eos_token_id=EOS)


def port_sampling(max_new=MAX_NEW, temperature=0.0):
    return tgen.SamplingConfig(max_new_tokens=max_new, temperature=temperature,
                               eos_token_id=EOS)


@pytest.fixture(scope="module")
def jax_dense(models, grammars):
    b = jbatching.ContinuousBatcher(models[0], CFG, max_slots=SLOTS, cache_len=CACHE_LEN,
                                    sampling=jax_sampling())
    return drive(b, grammars[0])


@pytest.mark.parametrize("variant", ["whole", "chunked", "burst"])
def test_dense_batcher_tokens_match_jax(models, grammars, strings, jax_dense, variant):
    kw = {"whole": {}, "chunked": dict(prefill_chunk=16), "burst": dict(multi_step=4)}[variant]
    b = tbatching.ContinuousBatcher(models[1], TCFG, max_slots=SLOTS, cache_len=CACHE_LEN,
                                    sampling=port_sampling(), **kw)
    got = drive(b, grammars[1])
    assert got == jax_dense
    check_grammars(got, strings, grammars[1])
    assert not b.grammar_slots.any_active and b.grammar_slots.operand() is None


@pytest.mark.parametrize("name", ["int8-fused", "f32-split"])
def test_paged_batcher_tokens_match_jax(models, grammars, strings, jax_dense, name):
    quant = fused = name == "int8-fused"
    kw = dict(PAGED, kv_quant=quant, kv_fused=fused)
    if quant:
        jb = jpaged.PagedBatcher(models[0], CFG, sampling=jax_sampling(), **kw)
        want = drive(jb, grammars[0])
    else:
        want = jax_dense
    b = tpaged.PagedBatcher(models[1], TCFG, sampling=port_sampling(), **kw)
    got = drive(b, grammars[1])
    assert got == want
    check_grammars(got, strings, grammars[1])
    assert not b.active.any() and b.allocator.available == PAGED["num_pages"] - 1


def test_generate_stream_matches_jax(models, grammars, strings):
    """The port's stream is asked for bursts and speculation, which a grammar
    turns off (as in the JAX function); the free requests speculate, with
    greedy decoding's tokens."""
    params, port = models
    for ids, g, _, _ in scenario()[:4]:
        want = list(jgen.generate_stream(params, ids[None], None, None, CFG, jax_sampling(),
                                         grammar=None if g is None else grammars[0][g]))
        got = list(tgen.generate_stream(port, torch.from_numpy(ids)[None], None, None, TCFG,
                                        port_sampling(), multi_step=4, lookahead=3,
                                        grammar=None if g is None else grammars[1][g]))
        assert got == want
        if g is not None:
            assert grammars[1][g].dfa.matches(text(strings, got))


def recording(b):
    """Wrap `b._burst_device`: record (n, mask buffer or None, any grammar
    active) a burst."""
    seen = []
    inner = b._burst_device

    def burst(n, overrides, penalties, lp_out, grammar=None):
        seen.append((n, grammar, b.grammar_slots.any_active))
        return inner(n, overrides, penalties, lp_out, grammar)

    b._burst_device = burst
    return seen


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_bursts_off_while_a_grammar_is_active_and_mask_buffer_fixed(models, grammars, paged):
    """Every burst with a grammar active is a single step over the one fixed
    mask buffer, admissions included; bursts of 4 resume once the grammars
    finish (the free request of 12 tokens outlives them), with no mask."""
    if paged:
        b = tpaged.PagedBatcher(models[1], TCFG, sampling=port_sampling(), multi_step=4, **PAGED)
    else:
        b = tbatching.ContinuousBatcher(models[1], TCFG, max_slots=SLOTS, cache_len=CACHE_LEN,
                                        sampling=port_sampling(), multi_step=4)
    seen = recording(b)
    drive(b, grammars[1], reqs=scenario(late=True))
    masked = [(n, m) for n, m, active in seen if active]
    assert masked and all(n == 1 and m is not None for n, m in masked)
    assert len({m.data_ptr() for _, m in masked}) == 1
    assert masked[0][1] is b.grammar_slots.mask
    assert all(m is None for _, m, active in seen if not active)
    last_masked = max(i for i, (_, _, active) in enumerate(seen) if active)
    assert any(n == 4 for n, _, _ in seen[last_masked + 1:]) and b.bursts > 0


def test_generate_stream_mask_buffer_is_fixed(models, grammars, monkeypatch):
    """The serialized path's masked steps read one (1, V) buffer, rewritten
    with the grammar's row before each step, and run one step at a time."""
    seen = []
    inner = tgen.decode_multi_step

    def record(*args, mask=None, **kw):
        seen.append((args[6], mask, None if mask is None else mask.clone()))
        return inner(*args, mask=mask, **kw)

    monkeypatch.setattr(tgen, "decode_multi_step", record)
    ids, g, _, _ = scenario()[0]
    grammar = grammars[1][g]
    toks = list(tgen.generate_stream(models[1], torch.from_numpy(ids)[None], None, None, TCFG,
                                     port_sampling(), multi_step=8, grammar=grammar))
    assert seen and all(n == 1 for n, _, _ in seen)
    assert all(m is seen[0][1] for _, m, _ in seen)
    state = grammar.advance(0, toks[0])
    for (_, _, row), tok in zip(seen, toks[1:] + [EOS]):
        np.testing.assert_array_equal(row[0].numpy(), grammar.mask[state])
        state = grammar.advance(state, tok)


def test_lookahead_and_draft_refusals_carry_the_jax_message(models, grammars):
    from vis_zephyr_tpu_torch.serve.draft import DraftModel

    jb = jbatching.ContinuousBatcher(models[0], CFG, max_slots=2, cache_len=CACHE_LEN,
                                     sampling=jax_sampling(), lookahead=2)
    with pytest.raises(ValueError) as want:
        jb.submit(np.array([5, 6, 7]), grammar=grammars[0][0])
    port = models[1]
    for b in (tbatching.ContinuousBatcher(port, TCFG, max_slots=2, cache_len=CACHE_LEN,
                                          sampling=port_sampling(), lookahead=2),
              tpaged.PagedBatcher(port, TCFG, sampling=port_sampling(), lookahead=2,
                                  draft=DraftModel(port, TCFG, max_slots=SLOTS, cache_len=64),
                                  **PAGED)):
        with pytest.raises(ValueError) as got:
            b.submit(np.array([5, 6, 7]), grammar=grammars[1][0])
        assert str(got.value) == str(want.value)


def test_lazy_swap_keeps_the_dfa_state(models, strings):
    """A pool too small for the three slots' growth parks a slot in the
    middle of its grammar (three grammars of six or more words, whose
    replies cannot end early): it resumes in the state it left, and every
    stream equals eager allocation's."""
    grammars = [ts.TokenGrammar.from_regex(p, strings, EOS)
                for p in ("(w1[0-9]){6}", "w2[0-9]{1,2}(w3[0-9]){5}", "(w4[0-9]|w5[0-9]){7}")]
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(5, 256, (12,)).astype(np.int64), g, MAX_NEW, 0) for g in (0, 1, 2)]
    kw = dict(PAGED, page_size=8, num_pages=7, prefill_chunk=16)
    eager = drive(tpaged.PagedBatcher(models[1], TCFG, sampling=port_sampling(), **kw),
                  grammars, reqs=reqs)
    b = tpaged.PagedBatcher(models[1], TCFG, sampling=port_sampling(), lazy_alloc=True, **kw)
    parked = {}
    out, inn = b._swap_out, b._swap_in

    def swap_out(slot):
        parked[slot] = (b.grammar_slots.slot_grammar[slot], int(b.grammar_slots.slot_state[slot]))
        out(slot)

    def swap_in(slot, pages):
        state = (b.grammar_slots.slot_grammar[slot], int(b.grammar_slots.slot_state[slot]))
        assert state == parked[slot]
        inn(slot, pages)

    b._swap_out, b._swap_in = swap_out, swap_in
    got = drive(b, grammars, reqs=reqs)
    assert got == eager
    for (_, g, _, _), tokens in zip(reqs, got):
        assert grammars[g].dfa.matches(text(strings, tokens))
    assert any(g is not None and state > 0 for g, state in parked.values()), parked
    assert b.metrics is None and b.allocator.available == kw["num_pages"] - 1


def test_unconstrained_rows_unchanged_beside_grammars_and_other_operands(models, grammars,
                                                                        strings):
    """Sampled, penalized and logprobs requests and grammar slots on one
    paged batcher with the prefix cache and a multi-LoRA pack: the greedy
    unconstrained requests give the tokens of a run without grammars, the
    constrained ones (greedy and sampled) match their grammars, and the
    logprobs come with every token."""
    from vis_zephyr_tpu_torch.ops.mlora import make_random_pack

    port = models[1]
    pack = make_random_pack(TCFG, 2, 4, torch.Generator().manual_seed(0))
    kw = dict(PAGED, num_pages=32, prefill_chunk=16, prefix_cache=True, mlora=pack,
              adapter_names={"a": 1, "b": 2}, multi_step=4)
    shared = np.arange(5, 37, dtype=np.int64)  # two pages of a shared prompt prefix

    def run(with_grammars):
        b = tpaged.PagedBatcher(port, TCFG, sampling=port_sampling(12), **kw)
        g = grammars[1] if with_grammars else (None, None)
        hs = [b.submit(np.concatenate([shared, [40 + i]]), grammar=gr, adapter=ad, **extra)
              for i, (gr, ad, extra) in enumerate([
                  (None, "a", {}), (g[0], "b", {}), (None, None, dict(logprobs=2)),
                  (g[1], "a", dict(temperature=0.9, top_p=0.8)),
                  (None, "b", dict(frequency_penalty=0.5, presence_penalty=0.5)),
                  (g[0], None, dict(frequency_penalty=1.0, logprobs=1))])]
        b.run_until_drained()
        return [list(b.stream(h)) for h in hs], hs, b

    plain, _, _ = run(False)
    got, hs, b = run(True)
    for i in (0, 2, 4):
        assert got[i] == plain[i], i
    for i, g in ((1, 0), (3, 1), (5, 0)):
        assert grammars[1][g].dfa.matches(text(strings, got[i])), (i, got[i])
    assert len(hs[2].lp_log) == len(got[2]) and len(hs[5].lp_log) == len(got[5])
    assert b.prefix_cache.hits > 0
