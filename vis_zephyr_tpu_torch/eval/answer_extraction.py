"""Answer-letter extraction from free-form model output.

Behavioral parity with the reference's regex cascade
(`vis_zephyr/eval/eval_vqa.py:23-48`):
1. a letter bracketed by punctuation/space on both sides,
2. an isolated letter in any sentence after the first,
3. a letter as the very first character,
4. default "A".

The port's own copy of the JAX package's
`vis_zephyr_tpu/eval/answer_extraction.py`: the same code, imported without
JAX (`tests/test_torch_imports.py` holds each function to its original).
"""

from __future__ import annotations

import re


def extract_answer(output: str) -> str:
    matches = re.findall(r"(?<=[ .,(\[])([ABCD])(?=[ .,)\]])", output)
    if matches:
        return matches[0]

    sentences = re.split(r"(?<=[.!?])\s+", output)
    if len(sentences) > 1:
        for sentence in sentences[1:]:
            isolated = re.findall(r"(?<![a-zA-Z0-9])([ABCD])(?![a-zA-Z0-9])", sentence)
            if isolated:
                return isolated[0]

    first = re.match(r"^[ABCD]", output.strip())
    if first:
        return first.group(0)
    return "A"


def split_chunks(items, num_chunks: int):
    """Nearly-equal contiguous chunks (reference `eval_vqa.py:51-58`)."""
    import math

    size = math.ceil(len(items) / num_chunks)
    return [items[i : i + size] for i in range(0, len(items), size)]


def get_chunk(items, num_chunks: int, index: int):
    return split_chunks(items, num_chunks)[index]
