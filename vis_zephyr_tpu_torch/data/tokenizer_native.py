"""Native C++ BPE tokenizer: tokenizer.json → compact binary → ctypes.

The port's copy of `vis_zephyr_tpu/data/tokenizer_native.py`
(`convert_tokenizer_json`, `NativeTokenizer`): a BPE tokenizer over
Metaspace-normalized text with byte fallback (the Zephyr-7B-β checkpoint's)
that needs no Python tokenizer package, so the port serves with a real
tokenizer where `transformers` is absent. The C++ source is the JAX
package's `native/vzt_tokenizer.cpp`, read in place and built by
`data/native_lib.py` into `vis_zephyr_tpu_torch/build/` (never into
`native/`).

- `convert_tokenizer_json(path)` reads an HF fast-tokenizer `tokenizer.json`
  (model.type == "BPE") and emits the flat binary the C++ side loads: vocab
  strings, merge triples (left_id, right_id, merged_id) in rank order,
  special ids and normalizer flags.
- `NativeTokenizer` wraps the C ABI; encode and decode release the GIL, so
  serving threads tokenize concurrently. `convert_ids_to_tokens` reads the
  pieces back from the binary (the HF method, which the grammars' token
  strings take: ``▁`` pieces and ``<0xNN>`` bytes as written, where a
  decode of one id strips the leading space and mangles a lone byte).
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
from typing import List, Optional

from . import native_lib

MAGIC = 0x565A544B
FLAG_BYTE_FALLBACK = 1
FLAG_DUMMY_PREFIX = 2


def convert_tokenizer_json(path: str) -> bytes:
    """tokenizer.json (HF fast, BPE model) → the native binary format."""
    with open(path) as f:
        tj = json.load(f)
    model = tj["model"]
    if model.get("type") != "BPE":
        raise ValueError(f"unsupported tokenizer model type {model.get('type')!r}")
    vocab = model["vocab"]  # token → id
    id_to_token = [None] * len(vocab)
    for tok, i in vocab.items():
        id_to_token[i] = tok
    # Added tokens may extend past the BPE vocab (special tokens).
    for added in tj.get("added_tokens", []):
        i, tok = added["id"], added["content"]
        if i >= len(id_to_token):
            id_to_token.extend([None] * (i + 1 - len(id_to_token)))
        id_to_token[i] = tok
    if any(t is None for t in id_to_token):
        raise ValueError("vocab has holes")

    merges = []
    for m in model["merges"]:
        left, right = m if isinstance(m, list) else m.split(" ", 1)
        merged = left + right
        merges.append((vocab[left], vocab[right], vocab[merged]))

    flags = 0
    if model.get("byte_fallback"):
        flags |= FLAG_BYTE_FALLBACK

    def walk_pretokenizers(node):
        if not node:
            return []
        if node.get("type") == "Sequence":
            out = []
            for sub in node.get("pretokenizers", node.get("normalizers", [])):
                out.extend(walk_pretokenizers(sub))
            return out
        return [node]

    meta_nodes = walk_pretokenizers(tj.get("pre_tokenizer")) + walk_pretokenizers(
        tj.get("normalizer")
    )
    for node in meta_nodes:
        if node.get("type") == "Metaspace":
            prepend = node.get("prepend_scheme", "always")
            if node.get("add_prefix_space", True) and prepend != "never":
                flags |= FLAG_DUMMY_PREFIX
        if node.get("type") == "Prepend":  # normalizer-style prefix
            flags |= FLAG_DUMMY_PREFIX

    def special_id(*names, default):
        for name in names:
            if name in vocab:
                return vocab[name]
            for added in tj.get("added_tokens", []):
                if added["content"] == name:
                    return added["id"]
        return default

    unk = special_id("<unk>", default=0)
    bos = special_id("<s>", default=1)
    eos = special_id("</s>", default=2)

    out = bytearray()
    out += struct.pack("<7I", MAGIC, 1, flags, len(id_to_token), len(merges),
                       unk, bos)
    out += struct.pack("<I", eos)
    for tok in id_to_token:
        b = tok.encode("utf-8")
        out += struct.pack("<I", len(b)) + b
    for a, b_, m in merges:
        out += struct.pack("<3I", a, b_, m)
    return bytes(out)


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = native_lib.load("vzt_tokenizer", "vzt_tokenizer.cpp", ["-O3"])
    if lib is None:
        return None
    lib.vzt_tok_load.restype = ctypes.c_void_p
    lib.vzt_tok_load.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.vzt_tok_free.argtypes = [ctypes.c_void_p]
    lib.vzt_tok_vocab_size.restype = ctypes.c_int
    lib.vzt_tok_vocab_size.argtypes = [ctypes.c_void_p]
    lib.vzt_tok_encode.restype = ctypes.c_int
    lib.vzt_tok_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.vzt_tok_decode.restype = ctypes.c_int
    lib.vzt_tok_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeTokenizer:
    """C++ BPE tokenizer handle. Construct from a model dir (containing
    tokenizer.json) or a prebuilt binary blob."""

    def __init__(self, model_dir: Optional[str] = None, blob: Optional[bytes] = None,
                 bos_token_id: int = 1, eos_token_id: int = 2,
                 pad_token_id: int = 2, model_max_length: int = 2048):
        lib = _load()
        if lib is None:
            raise RuntimeError("native tokenizer library unavailable: "
                               + native_lib.build_error.get("vzt_tokenizer", "not built"))
        if blob is None:
            if model_dir is None:
                raise ValueError("need model_dir or blob")
            blob = convert_tokenizer_json(os.path.join(model_dir, "tokenizer.json"))
        self._lib = lib
        self._blob = blob  # keep alive: the C side may reference it during load
        self._h = lib.vzt_tok_load(blob, len(blob))
        if not self._h:
            raise ValueError("native tokenizer rejected the binary blob")
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.model_max_length = model_max_length

    def __call__(self, text: str):
        """HF-style call: the serving/tokenization layer's contract is
        ``tokenizer(text).input_ids`` plus bos/pad ids
        (`data/tokenization.py:1-15`)."""
        from types import SimpleNamespace

        return SimpleNamespace(input_ids=self.encode(text, add_bos=True))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.vzt_tok_free(h)
            self._h = None

    @property
    def vocab_size(self) -> int:
        return self._lib.vzt_tok_vocab_size(self._h)

    def convert_ids_to_tokens(self, ids) -> List[str]:
        """The vocabulary pieces of `ids` as the tokenizer.json holds them,
        read back from the binary (after its 8-word header, whose fourth
        word is the vocabulary's size: a length-prefixed piece an id)."""
        if not hasattr(self, "_pieces"):
            n = struct.unpack_from("<I", self._blob, 12)[0]
            pieces, off = [], 32
            for _ in range(n):
                (length,) = struct.unpack_from("<I", self._blob, off)
                pieces.append(self._blob[off + 4: off + 4 + length].decode("utf-8"))
                off += 4 + length
            self._pieces = pieces
        return [self._pieces[int(i)] for i in ids]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        raw = text.encode("utf-8")
        cap = max(64, len(raw) * 2 + 8)
        while True:
            buf = (ctypes.c_int32 * cap)()
            n = self._lib.vzt_tok_encode(self._h, raw, len(raw), buf, cap)
            if n >= 0:
                ids = list(buf[:n])
                return ([self.bos_token_id] + ids) if add_bos else ids
            # -n is the true required count (the C side keeps counting past
            # the overflow); doubling is belt-and-braces against any future
            # encoder whose retry hint is partial.
            cap = max(-n + 8, cap * 2)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens:
            ids = [i for i in ids if i not in (self.bos_token_id, self.eos_token_id)]
        arr = (ctypes.c_int32 * len(ids))(*ids)
        cap = max(64, len(ids) * 8)
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.vzt_tok_decode(self._h, arr, len(ids), buf, cap)
            if n >= 0:
                return buf.raw[:n].decode("utf-8", errors="replace")
            cap = max(-n + 8, cap * 2)
