"""Prompt tokenization with image placeholders + supervised label masking.

The port's copy of the JAX package's `data/tokenization.py`:
`tokenize_with_images` (serving) and `mask_labels_zephyr`,
`preprocess_zephyr`, `preprocess_pretrain` and `preprocess` (training).
Host-side and tokenizer-agnostic: any HF-style tokenizer works
(``tokenizer(text).input_ids`` returns a list of ints; ``bos_token_id`` and
``model_max_length`` attributes are honoured).

Behavioral parity:
- `tokenize_with_images`   ↔ reference `vis_zephyr/model/mm_utils.py:91-128`
- `mask_labels_zephyr`     ↔ reference `vis_zephyr/train/train.py:366-484`
  (`preprocess_zephyr` label masking, including the mask-everything
  fallback on a tokenization mismatch)
- `preprocess_pretrain`    ↔ reference `train/train.py:329-364`
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..constants import DEFAULT_IMAGE_TOKEN, IGNORE_INDEX, IMAGE_TOKEN_INDEX
from ..conversation import Conversation, SeparatorStyle, default_conversation


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


def mask_labels_zephyr(
    conversation_text: str,
    input_ids: np.ndarray,
    tokenizer,
    conv: Optional[Conversation] = None,
    has_image: bool = False,
    warn=None,
) -> np.ndarray:
    """Produce supervised labels for one rendered Zephyr conversation.

    Only assistant reply tokens (and the closing separator) keep their ids;
    BOS, system and user turns, the ``<|assistant|>\\n`` header, padding and
    trailing slack are set to ``IGNORE_INDEX``.

    Turn spans are computed by *prefix-diff*: the rendered conversation is
    re-tokenized at every ``</s>`` turn boundary and consecutive lengths are
    differenced. Because the separator is a special token, tokenization on
    either side of it is independent, so the spans are exact for any
    tokenizer. (The reference instead re-tokenizes each turn standalone and
    subtracts 2 — `train/train.py:437-460` — a sentencepiece-specific
    correction; intended behavior is identical and we keep its
    mask-everything fallback for genuinely inconsistent tokenizers.)
    """
    conv = conv or default_conversation
    labels = np.asarray(input_ids).copy()

    # Sequences reach this function unpadded (batch padding happens in the
    # collator), so the true length is the array length. The reference
    # instead counts `!= pad_token_id` (`train/train.py:434`) — but Zephyr
    # sets pad == eos and "</s>" appears literally in the rendered text, so
    # that count undercounts and can trip the mask-everything fallback.
    total_length = int(labels.shape[0])

    system_header = "<|system|>\n"
    user_header = f"<|{conv.roles[0]}|>\n"
    assistant_header = f"<|{conv.roles[1]}|>\n"

    def tok_len(text: str) -> int:
        if has_image:
            return len(tokenize_with_images(text, tokenizer))
        return len(_ids(tokenizer, text))

    turns = conversation_text.split(conv.separator)

    cursor = tok_len("") if tok_len("") > 0 else 0  # BOS-only prefix
    labels[:cursor] = IGNORE_INDEX
    prefix = ""
    prev_len = cursor
    for turn in turns:
        if not turn:
            break
        prefix += turn + conv.separator
        turn_len = tok_len(prefix) - prev_len
        prev_len += turn_len

        is_assistant = not (system_header in turn or user_header in turn)
        if not is_assistant:
            labels[cursor : cursor + turn_len] = IGNORE_INDEX
        else:
            # Mask only the "<|assistant|>\n" header inside the turn. Its
            # length = prefix-diff of appending just the header.
            header_len = tok_len(prefix[: len(prefix) - len(turn) - len(conv.separator)] + assistant_header) - (prev_len - turn_len)
            labels[cursor : cursor + header_len] = IGNORE_INDEX
        cursor += turn_len

    labels[cursor:] = IGNORE_INDEX

    model_max_length = getattr(tokenizer, "model_max_length", None)
    if model_max_length is None or cursor < model_max_length:
        if cursor != total_length:
            labels[:] = IGNORE_INDEX
            if warn is not None:
                warn(
                    f"Tokenization mismatch (cur_len={cursor}, "
                    f"total_len={total_length}). Ignoring sample."
                )
    return labels


def preprocess_zephyr(
    sources: Sequence[Sequence[Dict[str, str]]],
    tokenizer,
    has_image: bool = False,
    conv: Optional[Conversation] = None,
    warn=None,
) -> Dict[str, List[np.ndarray]]:
    """Render + tokenize + label-mask a batch of chat transcripts.

    ``sources`` follow the reference JSON schema: a list of conversations,
    each a list of ``{"from": "human"|"gpt", "value": str}`` turns.
    """
    conv = (conv or default_conversation).copy()
    role_of = {"human": conv.roles[0], "gpt": conv.roles[1]}

    rendered: List[str] = []
    for source in sources:
        if role_of[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = role_of[sentence["from"]]
            if role != conv.roles[j % 2]:
                raise ValueError("Conversation role mismatch.")
            conv.append_message(role, sentence["value"])
        rendered.append(conv.get_prompt())

    if has_image:
        input_ids = [
            np.asarray(tokenize_with_images(p, tokenizer), dtype=np.int64) for p in rendered
        ]
    else:
        input_ids = [np.asarray(_ids(tokenizer, p), dtype=np.int64) for p in rendered]

    labels = [
        mask_labels_zephyr(text, ids, tokenizer, conv=conv, has_image=has_image, warn=warn)
        for text, ids in zip(rendered, input_ids)
    ]
    return {"input_ids": input_ids, "labels": labels}


def preprocess_pretrain(
    sources: Sequence[Sequence[Dict[str, str]]],
    tokenizer,
    separator: str = "</s>",
) -> Dict[str, List[np.ndarray]]:
    """Stage-1 pretrain preprocessing: ``<image>{caption}</s>`` with the
    image-token prefix masked from the loss."""
    input_ids: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    for source in sources:
        if len(source) != 2:
            raise ValueError("Pretrain conversation must have exactly 2 messages.")
        if DEFAULT_IMAGE_TOKEN not in source[0]["value"]:
            raise ValueError("Pretrain conversation must contain the image token.")
        text = DEFAULT_IMAGE_TOKEN + source[1]["value"] + separator
        ids = np.asarray(tokenize_with_images(text, tokenizer), dtype=np.int64)
        target = ids.copy()
        prefix_len = len(tokenize_with_images(DEFAULT_IMAGE_TOKEN, tokenizer))
        target[:prefix_len] = IGNORE_INDEX
        input_ids.append(ids)
        labels.append(target)
    return {"input_ids": input_ids, "labels": labels}


def preprocess(
    sources,
    tokenizer,
    has_image: bool = False,
    conv: Optional[Conversation] = None,
    warn=None,
) -> Dict[str, List[np.ndarray]]:
    """Dispatch on the active conversation template style
    (reference `train/train.py:487-506`)."""
    conv = conv or default_conversation
    if conv.separator_style is SeparatorStyle.ZEPHYR:
        return preprocess_zephyr(sources, tokenizer, has_image=has_image, conv=conv, warn=warn)
    if conv.separator_style is SeparatorStyle.PLAIN:
        return preprocess_pretrain(sources, tokenizer, separator=conv.separator)
    raise ValueError(f"Unsupported conversation style: {conv.separator_style}")
