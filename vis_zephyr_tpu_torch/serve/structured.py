"""Structured output: grammar-masked decoding (regex / JSON schema).

The port's copy of `vis_zephyr_tpu/serve/structured.py`. An OpenAI-style
``response_format`` (or a forced tool call) compiles to a byte-level DFA,
the DFA lifts to a token-level transition table over the tokenizer's
vocabulary, and every decode step masks the logits to the tokens that keep
the output inside the grammar, so the output matches without a retry loop.

The split of the work:
- compile time (host, once a grammar, cached by the engine): regex → NFA →
  DFA over bytes, then a vectorized numpy walk of every vocabulary token's
  bytes through the DFA → ``token_trans [S, V]`` and the bool
  ``mask [S+1, V]`` (numpy, as in the JAX module);
- decode time (device): each slot's mask row is gathered into one fixed
  buffer ``[max_slots, V]`` (`GrammarSlots.gather`, an `index_select` with
  ``out=``) that the captured decode step reads, and the sampler drops the
  masked tokens (`generate._sample`: ``masked_fill(~mask, -inf)``);
- between steps (host): the scheduler advances each constrained slot's
  state with one ``token_trans[state, token]`` lookup.

The mask table's LAST row is all-True: unconstrained slots point at it, so
one step serves a batch that mixes constrained and free requests.

EOS is part of the grammar: its mask column is the DFA's accept flag, so
generation can only stop on a complete match (and must stop when a state
allows nothing else).
"""

from __future__ import annotations

import dataclasses
import json
from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Regex parsing (byte-level subset: literals, escapes, ., classes, groups,
# alternation, * + ? {m} {m,} {m,n})
# ---------------------------------------------------------------------------

_CLS_ESCAPES = {
    "d": "0123456789",
    "w": "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_",
    "s": " \t\n\r\f\v",
}
_CHAR_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v", "0": "\0"}

# Resource caps: grammars arrive from unauthenticated requests, and both
# constructions can explode (nested bounded repetition for the NFA, subset
# construction for the DFA). Going past a cap is a ValueError, which the
# serving layers turn into a 400. The token mask is [S+1, V] bool, so 4096
# DFA states bound it at about 128 MB for a 32K vocabulary.
_MAX_REPETITION = 1024
_MAX_NFA_STATES = 100_000
_MAX_DFA_STATES = 4096


def _escape_set(ch: str) -> Optional[set]:
    if ch in _CLS_ESCAPES:
        return {ord(c) for c in _CLS_ESCAPES[ch]}
    if ch in ("D", "W", "S"):
        return set(range(256)) - {ord(c) for c in _CLS_ESCAPES[ch.lower()]}
    return None


_NON_ASCII_IN_CLASS = ("regex: non-ASCII character in a character class; "
                       "use \\xNN byte escapes (UTF-8) instead")


class _Parser:
    """Recursive-descent regex → AST. Nodes:
    ("lit", set[int]) | ("cat", [n...]) | ("alt", [n...]) |
    ("star", n) | ("plus", n) | ("opt", n) | ("rep", n, lo, hi|None)."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"regex: unexpected {self.p[self.i]!r} at {self.i}")
        return node

    def _peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        parts = []
        while self._peek() not in ("", "|", ")"):
            parts.append(self._quant())
        if not parts:
            return ("cat", [])  # an empty branch matches ""
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _quant(self):
        node = self._atom()
        while True:
            ch = self._peek()
            if ch in ("*", "+", "?"):
                self.i += 1
                node = ({"*": "star", "+": "plus", "?": "opt"}[ch], node)
            elif ch == "{":
                j = self.p.find("}", self.i)
                if j < 0:
                    raise ValueError("regex: unterminated {")
                body = self.p[self.i + 1: j]
                self.i = j + 1
                if "," in body:
                    lo_s, hi_s = body.split(",", 1)
                    lo = int(lo_s or 0)
                    hi = int(hi_s) if hi_s.strip() else None
                else:
                    lo = hi = int(body)
                if lo < 0 or (hi is not None and hi < lo):
                    raise ValueError(f"regex: bad repetition {{{body}}}")
                # A bounded repetition expands to lo + (hi - lo) fragments;
                # cap the expansion (the NFA state budget backstops nesting).
                if max(lo, hi or 0) > _MAX_REPETITION:
                    raise ValueError(f"regex: repetition bound over {_MAX_REPETITION}")
                node = ("rep", node, lo, hi)
            else:
                return node

    def _atom(self):
        ch = self._peek()
        if ch == "(":
            self.i += 1
            if self.p[self.i: self.i + 2] == "?:":  # non-capturing marker
                self.i += 2
            node = self._alt()
            if self._peek() != ")":
                raise ValueError("regex: unbalanced (")
            self.i += 1
            return node
        if ch == "[":
            return self._char_class()
        if ch == ".":
            self.i += 1
            return ("lit", set(range(256)) - {ord("\n")})
        if ch == "\\":
            self.i += 1
            group = _escape_set(self._peek())
            if group is not None:
                self.i += 1
                return ("lit", group)
            return ("lit", {self._escape_char()})
        if ch in ("*", "+", "?", "{"):
            raise ValueError(f"regex: dangling quantifier at {self.i}")
        self.i += 1
        if ord(ch) > 127:
            # A non-ASCII character is a SEQUENCE of UTF-8 bytes, not an
            # alternation over them.
            return ("cat", [("lit", {b}) for b in ch.encode("utf-8")])
        return ("lit", {ord(ch)})

    def _escape_char(self) -> int:
        """After a backslash: consume one escaped character (\\xNN too) and
        return its byte value."""
        esc = self._peek()
        self.i += 1
        if esc == "x":
            code = int(self.p[self.i: self.i + 2], 16)
            self.i += 2
            return code
        code = ord(_CHAR_ESCAPES.get(esc, esc))
        if code > 127:
            raise ValueError("regex: non-ASCII escape is not a single byte; use \\xNN "
                             "byte escapes (UTF-8) instead")
        return code

    def _char_class(self):
        assert self._peek() == "["
        self.i += 1
        negate = self._peek() == "^"
        if negate:
            self.i += 1
        chars: set = set()
        first = True
        while True:
            ch = self._peek()
            if ch == "":
                raise ValueError("regex: unterminated [")
            if ch == "]" and not first:
                self.i += 1
                break
            first = False
            if ch == "\\":
                self.i += 1
                group = _escape_set(self._peek())
                if group is not None:
                    self.i += 1
                    chars |= group
                    continue
                lo = self._escape_char()
            else:
                self.i += 1
                lo = ord(ch)
                if lo > 127:
                    # A class member is ONE byte; a multi-byte character is not.
                    raise ValueError(_NON_ASCII_IN_CLASS)
            if self._peek() == "-" and self.p[self.i + 1: self.i + 2] not in ("]", ""):
                self.i += 1
                if self._peek() == "\\":
                    self.i += 1
                    hi = self._escape_char()
                else:
                    hi = ord(self._peek())
                    self.i += 1
                    if hi > 127:
                        raise ValueError(_NON_ASCII_IN_CLASS)
                chars |= set(range(lo, hi + 1))
            else:
                chars.add(lo)
        if negate:
            chars = set(range(256)) - chars
        return ("lit", chars)


# ---------------------------------------------------------------------------
# Thompson NFA → subset-construction DFA
# ---------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[Dict[int, List[int]]] = []  # state → byte → targets

    def new_state(self) -> int:
        if len(self.eps) >= _MAX_NFA_STATES:
            raise ValueError(f"regex too large (over {_MAX_NFA_STATES} NFA states)")
        self.eps.append([])
        self.edges.append({})
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].append(b)

    def add_edge(self, a: int, bytes_: set, b: int) -> None:
        for byte in bytes_:
            self.edges[a].setdefault(byte, []).append(b)


def _build_nfa(node, nfa: _NFA) -> Tuple[int, int]:
    """AST node → (start, end) NFA fragment."""
    kind = node[0]
    if kind == "lit":
        s, e = nfa.new_state(), nfa.new_state()
        nfa.add_edge(s, node[1], e)
        return s, e
    if kind == "cat":
        if not node[1]:
            s = nfa.new_state()
            return s, s
        s, e = _build_nfa(node[1][0], nfa)
        for sub in node[1][1:]:
            s2, e2 = _build_nfa(sub, nfa)
            nfa.add_eps(e, s2)
            e = e2
        return s, e
    if kind == "alt":
        s, e = nfa.new_state(), nfa.new_state()
        for sub in node[1]:
            s2, e2 = _build_nfa(sub, nfa)
            nfa.add_eps(s, s2)
            nfa.add_eps(e2, e)
        return s, e
    if kind == "star":
        s, e = nfa.new_state(), nfa.new_state()
        s2, e2 = _build_nfa(node[1], nfa)
        nfa.add_eps(s, s2)
        nfa.add_eps(s, e)
        nfa.add_eps(e2, s2)
        nfa.add_eps(e2, e)
        return s, e
    if kind == "plus":
        return _build_nfa(("cat", [node[1], ("star", node[1])]), nfa)
    if kind == "opt":
        return _build_nfa(("alt", [node[1], ("cat", [])]), nfa)
    if kind == "rep":
        _, sub, lo, hi = node
        parts = [sub] * lo
        if hi is None:
            parts.append(("star", sub))
        else:
            parts.extend([("opt", sub)] * (hi - lo))
        return _build_nfa(("cat", parts), nfa)
    raise ValueError(f"unknown node {kind}")


@dataclasses.dataclass
class ByteDFA:
    """Deterministic automaton over bytes: `trans [S, 256]` (−1 = reject),
    `accept [S]`, start state 0."""

    trans: np.ndarray
    accept: np.ndarray

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    def matches(self, text) -> bool:
        state = 0
        for b in text.encode("utf-8") if isinstance(text, str) else text:
            state = int(self.trans[state, b])
            if state < 0:
                return False
        return bool(self.accept[state])


def compile_regex(pattern: str) -> ByteDFA:
    """Full-match regex → byte DFA (subset construction)."""
    nfa = _NFA()
    start, end = _build_nfa(_Parser(pattern).parse(), nfa)

    def closure(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure(frozenset([start]))
    dfa_ids: Dict[frozenset, int] = {start_set: 0}
    order = [start_set]
    trans_rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        row = np.full(256, -1, np.int32)
        by_byte: Dict[int, set] = {}
        for s in order[i]:
            for byte, targets in nfa.edges[s].items():
                by_byte.setdefault(byte, set()).update(targets)
        for byte, targets in by_byte.items():
            nxt = closure(frozenset(targets))
            if nxt not in dfa_ids:
                if len(order) >= _MAX_DFA_STATES:
                    raise ValueError(f"regex too large (over {_MAX_DFA_STATES} DFA states)")
                dfa_ids[nxt] = len(order)
                order.append(nxt)
            row[byte] = dfa_ids[nxt]
        trans_rows.append(row)
        i += 1
    return ByteDFA(trans=np.stack(trans_rows), accept=np.asarray([end in s for s in order]))


# ---------------------------------------------------------------------------
# Token-level grammar (the DFA lifted over the tokenizer's vocabulary)
# ---------------------------------------------------------------------------


def token_strings_from_tokenizer(tokenizer, vocab_size: Optional[int] = None) -> List[bytes]:
    """The RAW BYTES each vocabulary id contributes to decoded text.

    HF sentencepiece-style tokenizers (and the port's `NativeTokenizer`):
    `convert_ids_to_tokens` with the ``▁`` → space and ``<0xNN>`` → byte
    conventions; other tokenizers: a `decode` per id. Bytes, not str: a
    byte-fallback token ``<0xC3>`` is the single byte 0xC3, which as a str
    would re-encode to two UTF-8 bytes and walk the wrong path."""
    V = vocab_size or getattr(tokenizer, "vocab_size", None) or len(tokenizer.get_vocab())
    conv = getattr(tokenizer, "convert_ids_to_tokens", None)
    out: List[bytes] = []
    if conv is not None:
        for t in conv(list(range(V))):
            if t is None:
                out.append(b"")
            elif len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                out.append(bytes([int(t[3:5], 16)]))
            elif t.startswith("<") and t.endswith(">"):
                out.append(b"")  # special tokens contribute no text
            else:
                out.append(t.replace("▁", " ").encode("utf-8"))
        return out
    for i in range(V):
        try:
            out.append(tokenizer.decode([i], skip_special_tokens=True).encode("utf-8"))
        except Exception:  # noqa: BLE001 — an id the tokenizer cannot decode adds nothing
            out.append(b"")
    return out


class TokenGrammar:
    """A compiled grammar over a fixed vocabulary.

    - ``mask`` bool [S+1, V]: row s = the tokens legal from DFA state s (the
      EOS column is the accept flag); the LAST row is all-True, for the
      unconstrained slots that share the batch.
    - ``token_trans`` int32 [S, V]: the next DFA state per (state, token).
    - `advance(state, token)` is the host's update per emitted token.
    """

    def __init__(self, dfa: ByteDFA, token_strings: Sequence, eos_token_id: int):
        self.dfa = dfa
        self.eos_token_id = eos_token_id
        self._device_masks: Dict[torch.device, torch.Tensor] = {}
        S = dfa.n_states
        V = len(token_strings)

        # Token bytes in a padded matrix for a vectorized DFA walk (str
        # entries, from hand-built vocabularies, are encoded).
        blobs = [t if isinstance(t, bytes) else t.encode("utf-8") for t in token_strings]
        lens = np.asarray([len(b) for b in blobs], np.int32)
        L = max(1, int(lens.max()))
        mat = np.zeros((V, L), np.uint8)
        for i, b in enumerate(blobs):
            if b:
                mat[i, : len(b)] = np.frombuffer(b, np.uint8)

        token_trans = np.empty((S, V), np.int32)
        for s in range(S):
            st = np.full(V, s, np.int32)
            for j in range(L):
                live = (j < lens) & (st >= 0)
                nxt = dfa.trans[np.maximum(st, 0), mat[:, j]]
                st = np.where(live, nxt, st)
            token_trans[s] = st
        # Zero-length tokens advance nothing: emitting them would loop
        # forever inside the grammar, so they are never legal.
        token_trans[:, lens == 0] = -1
        if 0 <= eos_token_id < V:
            token_trans[:, eos_token_id] = np.where(dfa.accept, np.arange(S), -1)

        # Trim to the co-accessible states: a token whose target can never
        # reach acceptance THROUGH WHOLE TOKENS is itself illegal (a
        # word-level vocabulary with "w10" but no bare "0" strands "w1").
        # Fixed point: live(s) ⇐ accept(s) or some token reaches a live
        # state; then the transitions into dead states go.
        live = dfa.accept.copy()
        while True:
            new_live = live | ((token_trans >= 0) & live[np.maximum(token_trans, 0)]).any(axis=1)
            if (new_live == live).all():
                break
            live = new_live
        token_trans = np.where((token_trans >= 0) & live[np.maximum(token_trans, 0)],
                               token_trans, -1)

        mask = np.zeros((S + 1, V), bool)
        mask[:S] = token_trans >= 0
        if 0 <= eos_token_id < V:
            mask[:S, eos_token_id] = dfa.accept
        mask[S] = True  # the unconstrained row
        self.token_trans = token_trans
        self.mask = mask

        # Decodability: after trimming every surviving transition leads to a
        # live state, so a dead end mid-decode is impossible; only an
        # unusable START state is left to check.
        if not mask[0].any():
            raise ValueError("grammar is not decodable with this vocabulary: no token "
                             "sequence can produce a conforming output")

    @property
    def n_states(self) -> int:
        return self.dfa.n_states

    @property
    def free_state(self) -> int:
        """Index of the all-True mask row (unconstrained slots)."""
        return self.dfa.n_states

    def advance(self, state: int, token: int) -> int:
        return int(self.token_trans[state, token])

    def mask_on(self, device) -> torch.Tensor:
        """`mask` as a bool tensor on `device`, copied there once."""
        device = torch.device(device)
        got = self._device_masks.get(device)
        if got is None:
            got = self._device_masks[device] = torch.from_numpy(self.mask).to(device)
        return got

    @classmethod
    def from_regex(cls, pattern: str, token_strings: Sequence,
                   eos_token_id: int) -> "TokenGrammar":
        return cls(compile_regex(pattern), token_strings, eos_token_id)

    @classmethod
    def from_json_schema(cls, schema: dict, token_strings: Sequence,
                         eos_token_id: int) -> "TokenGrammar":
        return cls.from_regex(schema_to_regex(schema), token_strings, eos_token_id)


# ---------------------------------------------------------------------------
# JSON schema → regex
# ---------------------------------------------------------------------------

# One OPTIONAL whitespace character between JSON punctuation, not a Kleene
# star: an unbounded whitespace loop is a live trap for a greedy step whose
# argmax lands on the space token (it can repeat it to the budget without
# leaving the grammar). json.dumps spacing fits.
_WS = "[ \\n\\t]?"
_STRING = '"([^"\\\\\\x00-\\x1f]|\\\\["\\\\/bfnrt]|\\\\u[0-9a-fA-F]{4})*"'
_INTEGER = "-?(0|[1-9][0-9]*)"
_NUMBER = "-?(0|[1-9][0-9]*)(\\.[0-9]+)?([eE][+-]?[0-9]+)?"


def _regex_escape(text: str) -> str:
    out = []
    for ch in text:
        if ch in r"\.[]{}()*+?|^$/-":
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        else:
            out.append(ch)
    return "".join(out)


def schema_to_regex(schema: dict) -> str:
    """A JSON schema subset → a full-match regex for conforming documents.

    Served: object (fixed `properties` in declaration order; properties not
    in `required` may be left out), array (`items`, `minItems` /
    `maxItems`), string (`enum`, `pattern`), integer, number, boolean, null,
    `enum` of scalars, `const`. Free-form nesting (`additionalProperties`,
    an object without properties) is refused: a DFA needs a bounded shape."""
    t = schema.get("type")
    if "const" in schema:
        return _regex_escape(json.dumps(schema["const"]))
    if "enum" in schema:
        return "(" + "|".join(_regex_escape(json.dumps(v)) for v in schema["enum"]) + ")"
    if t == "string":
        if "pattern" in schema:
            return '"' + schema["pattern"] + '"'
        return _STRING
    if t == "integer":
        return _INTEGER
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = schema_to_regex(schema.get("items", {"type": "number"}))
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if lo < 0:
            raise ValueError(f"minItems must be >= 0, got {lo}")
        if hi is not None:
            hi = int(hi)
            if hi < lo:
                raise ValueError(f"maxItems {hi} < minItems {lo}")
            if hi == 0:
                return f"\\[{_WS}\\]"  # only the empty array conforms
        rest = f"({_WS},{_WS}{item})"
        if hi is None:
            body = f"{item}{rest}*" if lo <= 1 else f"{item}{rest}{{{lo - 1},}}"
        else:
            body = f"{item}{rest}{{{max(lo - 1, 0)},{hi - 1}}}"
        if lo == 0:
            return f"\\[{_WS}({body})?{_WS}\\]"
        return f"\\[{_WS}{body}{_WS}\\]"
    if t == "object":
        props = schema.get("properties")
        if not props:
            raise ValueError("structured output requires 'properties' on objects "
                             "(free-form objects are not regular)")
        required = set(schema.get("required", list(props)))
        parts = [(f'"{_regex_escape(name)}"{_WS}:{_WS}{schema_to_regex(sub)}', name in required)
                 for name, sub in props.items()]
        return f"\\{{{_WS}{_object_body(parts)}{_WS}\\}}"
    raise ValueError(f"unsupported schema: {schema!r}")


def _object_body(parts: List[Tuple[str, bool]]) -> str:
    """Property regexes → the body's alternation over the optional members:
    every allowed subset (all required ones kept) in declaration order, for
    the handful of properties a response schema carries."""
    optional_idx = [i for i, (_, req) in enumerate(parts) if not req]
    if not optional_idx:
        return f"{_WS},{_WS}".join(p for p, _ in parts)
    if len(optional_idx) > 8:
        raise ValueError("too many optional properties (max 8)")
    alts = []
    for r in range(len(optional_idx) + 1):
        for omit in combinations(optional_idx, r):
            kept = [p for i, (p, _) in enumerate(parts) if i not in omit]
            if kept:
                alts.append(f"{_WS},{_WS}".join(kept))
    if len(optional_idx) == len(parts):
        alts.append("")  # everything optional: "{}" conforms
    return "(" + "|".join(dict.fromkeys(alts)) + ")"


# ---------------------------------------------------------------------------
# The batchers' grammar state: the combined mask table on the device
# ---------------------------------------------------------------------------


class GrammarSlots:
    """Each slot's grammar and DFA state for a batcher, and the COMBINED mask
    table on the batcher's device (each active grammar's rows at an offset;
    the final row all-True for unconstrained slots).

    The table is rebuilt only when the set of distinct active grammars
    changes (admission, finish), never per step. `attach`, `release` and
    `advance` run on the host. `gather` fills one fixed buffer
    [max_slots, V] bool with every slot's row, which a captured decode step
    reads: its address never changes, so one capture serves every mix of
    grammars."""

    def __init__(self, max_slots: int, vocab_size: int, device=None):
        self.max_slots = max_slots
        self.vocab_size = vocab_size
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.slot_grammar: List[Optional[TokenGrammar]] = [None] * max_slots
        self.slot_state = np.zeros(max_slots, np.int64)  # local DFA state
        self._table: Optional[torch.Tensor] = None  # [R, V] bool, the combined mask
        self._offsets: Dict[int, int] = {}           # id(grammar) → row offset
        self._free_row = 0
        self._dirty = True
        self._rows: Optional[torch.Tensor] = None    # [max_slots] int64, fixed
        self.mask: Optional[torch.Tensor] = None     # [max_slots, V] bool, fixed

    @property
    def any_active(self) -> bool:
        return any(g is not None for g in self.slot_grammar)

    def attach(self, slot: int, grammar: Optional[TokenGrammar]) -> None:
        self.slot_grammar[slot] = grammar
        self.slot_state[slot] = 0
        if grammar is not None:
            self._dirty = True

    def release(self, slot: int) -> None:
        if self.slot_grammar[slot] is not None:
            self._dirty = True
        self.slot_grammar[slot] = None
        self.slot_state[slot] = 0

    def advance(self, slot: int, token: int) -> None:
        g = self.slot_grammar[slot]
        if g is None:
            return
        nxt = g.advance(int(self.slot_state[slot]), token)
        # A masked step emits only legal tokens; -1 here would mean that the
        # mask and the transition table disagree: fail loudly.
        if nxt < 0 and token != g.eos_token_id:
            raise RuntimeError(f"grammar desync: token {token} illegal from state "
                               f"{int(self.slot_state[slot])}")
        if nxt >= 0:
            self.slot_state[slot] = nxt

    def first_token_mask(self, grammar: TokenGrammar) -> torch.Tensor:
        """The start state's mask row [V] on the device, for sampling a
        request's first token from its admission logits."""
        return grammar.mask_on(self.device)[0]

    def operand(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """(combined_mask [R, V] bool, slot_rows [max_slots] int64) on the
        device, or None while no slot is constrained. `slot_rows` is one
        fixed buffer, rewritten by each call."""
        if not self.any_active:
            return None
        if self._dirty or self._table is None:
            blocks, self._offsets, off = [], {}, 0
            for g in self.slot_grammar:
                if g is not None and id(g) not in self._offsets:
                    self._offsets[id(g)] = off
                    blocks.append(g.mask[:-1])  # each grammar's free row goes
                    off += g.n_states
            blocks.append(np.ones((1, self.vocab_size), bool))
            self._table = torch.from_numpy(np.concatenate(blocks, axis=0)).to(self.device)
            self._free_row = off
            self._dirty = False
        rows = np.full(self.max_slots, self._free_row, np.int64)
        for slot, g in enumerate(self.slot_grammar):
            if g is not None:
                rows[slot] = self._offsets[id(g)] + int(self.slot_state[slot])
        if self._rows is None:
            self._rows = torch.zeros(self.max_slots, dtype=torch.int64, device=self.device)
        self._rows.copy_(torch.from_numpy(rows))
        return self._table, self._rows

    def gather(self) -> Optional[torch.Tensor]:
        """The fixed mask buffer [max_slots, V] bool filled with every slot's
        current row (`index_select` of the table, ``out=`` the buffer), or
        None while no slot is constrained. Call it before each masked step."""
        op = self.operand()
        if op is None:
            return None
        if self.mask is None:
            self.mask = torch.zeros((self.max_slots, self.vocab_size), dtype=torch.bool,
                                    device=self.device)
        torch.index_select(op[0], 0, op[1], out=self.mask)
        return self.mask
