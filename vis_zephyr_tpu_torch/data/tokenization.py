"""Prompt tokenization with image placeholders.

The port's copy of `tokenize_with_images` from the JAX package's
`data/tokenization.py` (the training-side label masking stays there until
training is ported). Host-side and tokenizer-agnostic: any HF-style
tokenizer works (``tokenizer(text).input_ids`` returns a list of ints; a
``bos_token_id`` attribute is honoured).
"""

from __future__ import annotations

from typing import List

from ..constants import DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX


def _ids(tokenizer, text: str) -> List[int]:
    out = tokenizer(text)
    ids = out.input_ids if hasattr(out, "input_ids") else out["input_ids"]
    return list(ids)


def tokenize_with_images(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    """Tokenize a prompt containing ``<image>`` placeholders.

    The prompt is split on ``<image>``; each text chunk is tokenized
    independently, then chunks are joined with a single ``image_token_index``
    sentinel. If the tokenizer prepends BOS, only the first chunk keeps it —
    later chunks have their leading BOS stripped.
    """
    chunks = [_ids(tokenizer, chunk) for chunk in prompt.split(DEFAULT_IMAGE_TOKEN)]

    bos = getattr(tokenizer, "bos_token_id", None)
    has_bos = bool(chunks and chunks[0] and bos is not None and chunks[0][0] == bos)

    ids: List[int] = []
    if has_bos:
        ids.append(chunks[0][0])
    offset = 1 if has_bos else 0
    for i, chunk in enumerate(chunks):
        if i > 0:
            ids.append(image_token_index)
        ids.extend(chunk[offset:])
    return ids
