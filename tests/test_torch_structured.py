"""The port's structured-output module against the JAX package's
(`serve/structured.py` in both), on the CPU.

- `compile_regex`: the byte DFA's transition and accept tables equal, and
  the same refusals, for the patterns of `tests/test_structured.py`;
- `schema_to_regex`: the same regex string for each schema (and the same
  refusals), and its DFA equal;
- `TokenGrammar`: `mask` [S+1, V] and `token_trans` [S, V] equal on a
  character vocabulary, on a multi-character one and on byte-fallback
  tokens, the co-accessible trim included, and the same `ValueError` for a
  grammar the vocabulary cannot decode;
- `GrammarSlots`: through a script of attach, advance and release, the port's
  combined table and rows equal JAX's `operand()`, the fixed mask buffer
  `gather` fills equals the table's rows and keeps its address, the table
  is rebuilt only when the set of grammars changes, and a desync raises
  as in JAX.
"""

import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from vis_zephyr_tpu.serve import structured as js
from vis_zephyr_tpu_torch.serve import structured as ts

VOCAB = 512
EOS = 2


def char_token_strings(vocab_size: int = VOCAB):
    """Ids 10..104 are the printable ASCII characters; the rest add no text
    (the JAX test's vocabulary)."""
    out = [""] * vocab_size
    for i in range(95):
        out[10 + i] = chr(32 + i)
    return out


def tok(ch: str) -> int:
    return 10 + ord(ch) - 32


PATTERNS = ["abc", "a|bc", "a*", "a+b?", "[0-9]{2,3}", "[a-c]+|x", "[^0-9]", "(ab)+c", "a{3}",
            "a{2,}", r"\d+\.\d+", r"\w+", r"\\n", r"\x41+", "(yes|no)( (yes|no))*", "a.c",
            "é+", "(?:ab|cd){1,3}", r"[\s\d]*z", "[ -~]*"]

SCHEMAS = [
    {"type": "integer"}, {"type": "number"}, {"type": "boolean"}, {"type": "null"},
    {"type": "string"}, {"enum": ["a", "b"]}, {"const": 5},
    {"type": "array", "items": {"type": "integer"}},
    {"type": "array", "items": {"type": "boolean"}, "minItems": 1, "maxItems": 2},
    {"type": "array", "items": {"type": "integer"}, "minItems": 3},
    {"type": "array", "maxItems": 0},
    {"type": "string", "pattern": "[A-Z]{2}"},
    {"type": "object", "properties": {"name": {"type": "string"}, "age": {"type": "integer"},
                                      "vip": {"type": "boolean"}}, "required": ["name"]},
    {"type": "object", "properties": {"a": {"type": "integer"}}, "required": []},
    {"type": "object", "properties": {"point": {"type": "object", "properties": {
        "x": {"type": "integer"}, "y": {"type": "integer"}}}}},
    {"type": "object", "properties": {"name": {"type": "string"}, "age": {"type": "integer"},
                                      "color": {"enum": ["red", "green", "blue"]}}},
]


def same_dfa(a, b) -> None:
    np.testing.assert_array_equal(a.trans, b.trans)
    np.testing.assert_array_equal(a.accept, b.accept)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_compile_regex_tables_match(pattern):
    same_dfa(ts.compile_regex(pattern), js.compile_regex(pattern))


@pytest.mark.parametrize("bad", ["(ab", "a)", "*a", "[ab", "a{2", "a{3,1}", "a{2000}",
                                 "[é]", "(a{1000}){1000}"])
def test_compile_regex_refusals_match(bad):
    with pytest.raises(ValueError) as want:
        js.compile_regex(bad)
    with pytest.raises(ValueError) as got:
        ts.compile_regex(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("schema", SCHEMAS, ids=lambda s: str(s)[:40])
def test_schema_to_regex_matches(schema):
    pattern = ts.schema_to_regex(schema)
    assert pattern == js.schema_to_regex(schema)
    same_dfa(ts.compile_regex(pattern), js.compile_regex(pattern))


@pytest.mark.parametrize("schema", [{"type": "object"}, {"type": "whatever"},
                                    {"type": "array", "minItems": 3, "maxItems": 1},
                                    {"type": "object", "properties": {
                                        f"p{i}": {"type": "null"} for i in range(9)},
                                     "required": []}])
def test_schema_refusals_match(schema):
    with pytest.raises(ValueError) as want:
        js.schema_to_regex(schema)
    with pytest.raises(ValueError) as got:
        ts.schema_to_regex(schema)
    assert str(got.value) == str(want.value)


def multi_char_strings():
    strings = [""] * 16
    strings[4], strings[5], strings[6], strings[7] = "w1", "ab", "c", "abc"
    strings[8], strings[9] = "w10", "w17"
    return strings


def byte_strings():
    """Byte-fallback tokens as `token_strings_from_tokenizer` gives them:
    single raw bytes, a few pieces, specials empty."""
    return [b"", b"", b""] + [bytes([b]) for b in range(256)] + [b" the", b"ab", b"\xc3\xa9"]


@pytest.mark.parametrize("pattern,strings", [
    ("ab+", "chars"), ("[ab]{4}", "chars"), ("-?[0-9]{2}", "chars"), ("(true|false)", "chars"),
    ('\\{"k": [0-9]\\}', "chars"), ("[ -~]*", "chars"), ("abc", "multi"), ("w1(0|7)", "multi"),
    ("é", "bytes"), (" the[a-z]*", "bytes"), (js.schema_to_regex(SCHEMAS[-1]), "chars"),
])
def test_token_grammar_tables_match(pattern, strings):
    strings = {"chars": char_token_strings(), "multi": multi_char_strings(),
               "bytes": byte_strings()}[strings]
    got = ts.TokenGrammar.from_regex(pattern, strings, EOS)
    want = js.TokenGrammar.from_regex(pattern, strings, EOS)
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.token_trans, want.token_trans)
    assert got.free_state == want.free_state and got.mask[got.free_state].all()
    state = 0
    for t in np.flatnonzero(got.mask[0])[:3]:
        assert got.advance(state, int(t)) == want.advance(state, int(t))


def test_json_schema_grammar_matches():
    got = ts.TokenGrammar.from_json_schema(SCHEMAS[-4], char_token_strings(), EOS)
    want = js.TokenGrammar.from_json_schema(SCHEMAS[-4], char_token_strings(), EOS)
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.token_trans, want.token_trans)


def test_undecodable_grammar_refused_as_in_jax():
    strings = [""] * 8
    strings[4] = "a"
    with pytest.raises(ValueError) as want:
        js.TokenGrammar.from_regex("aZ", strings, eos_token_id=2)
    with pytest.raises(ValueError, match="not decodable") as got:
        ts.TokenGrammar.from_regex("aZ", strings, eos_token_id=2)
    assert str(got.value) == str(want.value)


def test_mask_on_is_the_mask_copied_once():
    g = ts.TokenGrammar.from_regex("[ab]{4}", char_token_strings(), EOS)
    dev = g.mask_on("cpu")
    assert dev.dtype == torch.bool and np.array_equal(dev.numpy(), g.mask)
    assert g.mask_on(torch.device("cpu")) is dev


def test_grammar_slots_match_jax_operand():
    strings = char_token_strings()
    jga, jgb = (js.TokenGrammar.from_regex(p, strings, EOS) for p in ("a+", "[0-9]{2}"))
    tga, tgb = (ts.TokenGrammar.from_regex(p, strings, EOS) for p in ("a+", "[0-9]{2}"))
    jslots = js.GrammarSlots(max_slots=4, vocab_size=VOCAB)
    tslots = ts.GrammarSlots(max_slots=4, vocab_size=VOCAB, device="cpu")
    assert tslots.operand() is None and jslots.operand() is None and tslots.gather() is None
    buffer = None
    tables = []
    # (op, slot, grammar index or token): the JAX test's script and more.
    script = [("attach", 0, 0), ("attach", 2, 1), ("check",), ("advance", 2, tok("5")),
              ("check",), ("advance", 0, tok("a")), ("advance", 0, tok("a")), ("check",),
              ("attach", 1, 1), ("check",), ("release", 0), ("check",), ("advance", 1, tok("1")),
              ("check",), ("release", 2), ("release", 1), ("check",)]
    for op, *args in script:
        if op == "attach":
            jslots.attach(args[0], (jga, jgb)[args[1]])
            tslots.attach(args[0], (tga, tgb)[args[1]])
        elif op == "advance":
            jslots.advance(*args)
            tslots.advance(*args)
        elif op == "release":
            jslots.release(args[0])
            tslots.release(args[0])
        else:
            want, got = jslots.operand(), tslots.operand()
            if want is None:
                assert got is None and tslots.gather() is None
                continue
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            np.testing.assert_array_equal(tslots.slot_state, jslots.slot_state)
            tables.append(got[0])
            mask = tslots.gather()
            buffer = mask.data_ptr() if buffer is None else buffer
            assert mask.data_ptr() == buffer and mask.shape == (4, VOCAB)
            np.testing.assert_array_equal(mask.numpy(), np.asarray(want[0])[np.asarray(want[1])])
    # Advances reuse the table; attaching a third slot's grammar (the same
    # grammar as slot 2's) and releasing slot 0 rebuild it.
    assert tables[0] is tables[1] is tables[2]
    assert tables[3] is not tables[2] and tables[4] is not tables[3] and tables[5] is tables[4]


def test_first_token_mask_is_the_start_row():
    g = ts.TokenGrammar.from_regex("[0-9]{2}", char_token_strings(), EOS)
    slots = ts.GrammarSlots(2, VOCAB)
    np.testing.assert_array_equal(slots.first_token_mask(g).numpy(), g.mask[0])


def test_desync_raises_as_in_jax():
    strings = char_token_strings()
    errors = []
    for mod in (js, ts):
        slots = mod.GrammarSlots(2, VOCAB)
        slots.attach(0, mod.TokenGrammar.from_regex("a", strings, EOS))
        with pytest.raises(RuntimeError, match="desync") as err:
            slots.advance(0, tok("z"))
        errors.append(str(err.value))
        slots.advance(1, tok("z"))  # an unconstrained slot never desyncs
    assert errors[0] == errors[1]


@pytest.mark.parametrize("tokens", [["<s>", "▁the", "<0x41>", "x", None],
                                    ["<0xC3>", "<0xA9>", "</s>"]])
def test_token_strings_from_tokenizer_matches(tokens):
    class Conv:
        vocab_size = len(tokens)

        def convert_ids_to_tokens(self, ids):
            return tokens[: len(ids)]

    assert ts.token_strings_from_tokenizer(Conv()) == js.token_strings_from_tokenizer(Conv())
