"""ViP text machinery: unique shape/color assignment per entity, VCR
entity-tag rewriting, multiple-choice prompt/answer builders.

Reference: `vis_zephyr/model/vip_processor/utils.py:11-201`. VCR corpora are
mixed lists like ``["Why is", [0, 1], "smiling", "?"]`` where int-lists are
detection indices; rewriting turns them into e.g. "Why is the person within
the red rectangle and the object with the aqua scribble smiling ?".

The port's own copy of the JAX package's `vis_zephyr_tpu/data/vip/text.py`:
the same code, imported without JAX (`tests/test_torch_imports.py` holds each
function to its original).
"""

from __future__ import annotations

import collections
import random
from typing import Dict, List, Optional, Sequence, Tuple

from .config import (
    ANSWER_ADJECTIVES,
    ANSWER_LETTERS,
    ANSWER_PUNCTUATION,
    OPTIONS_PREFIXES,
    QUESTION_PREFIXES,
    SHAPE_WORDS,
    WHY_QUESTIONS,
)

_NO_SPACE_BEFORE = {".", ",", "?", "!", ":", ";"}


def collect_entity_indices(corpora: Sequence[Sequence]) -> List[int]:
    """All unique detection indices referenced by the corpora
    (reference `utils.py:37-48`)."""
    seen = set()
    for corpus in corpora:
        for item in corpus:
            if isinstance(item, list):
                seen.update(item)
    return sorted(seen)


def assign_shapes_and_colors(
    entity_indices: Sequence[int],
    shapes: Sequence[str],
    colors: Sequence[Tuple[str, Tuple[int, int, int]]],
    rng: random.Random,
) -> Dict[int, Tuple[Optional[str], Tuple[int, int, int], str]]:
    """Per entity: (color_name | None, rgb, shape) — shape+named-color pairs
    stay unique; when named colors run out, an unnamed random RGB is used
    (reference `utils.py:50-95`)."""
    chosen_shapes = rng.choices(list(shapes), k=len(entity_indices))
    counts = collections.Counter(chosen_shapes)
    non_unique = {s for s, c in counts.items() if c > 1}

    used_colors: Dict[str, List[str]] = {}
    out = {}
    for i, entity in enumerate(entity_indices):
        shape = chosen_shapes[i]
        used = used_colors.setdefault(shape, [])
        if shape in non_unique or used:
            available = [c for c in colors if c[0] not in used]
            if available:
                name, rgb = rng.choice(available)
                used.append(name)
            else:
                name, rgb = None, (rng.randint(0, 255), rng.randint(0, 255), rng.randint(0, 255))
        else:
            if rng.choice([True, False]):
                name, rgb = rng.choice(list(colors))
                used.append(name)
            else:
                name, rgb = None, (rng.randint(0, 255), rng.randint(0, 255), rng.randint(0, 255))
        out[entity] = (name, rgb, shape)
    return out


def rewrite_entity_tags(
    corpora: Sequence[Sequence],
    assignments: Dict[int, Tuple[Optional[str], Tuple[int, int, int], str]],
    class_names: Optional[Sequence[str]],
    rng: random.Random,
    answer_type: str = "",
) -> List[str]:
    """Render each corpus to text, replacing entity index lists with their
    visual-prompt descriptions (reference `utils.py:97-149`)."""
    rendered = []
    for corpus in corpora:
        text = ""
        for pos, item in enumerate(corpus):
            if isinstance(item, list):
                for j, entity in enumerate(item):
                    name, _, shape = assignments[entity]
                    text += "The " if (pos == 0 and j == 0) else " the "
                    if class_names is None:
                        text += "object"
                    elif rng.random() < 0.5 and answer_type != "direct":
                        text += rng.choice(["object", "instance"])
                    else:
                        text += class_names[entity]
                    prep, noun = SHAPE_WORDS[shape]
                    text += f" {prep} "
                    if rng.random() < 0.5:
                        text += "the "
                    if name is not None:
                        text += name + " "
                    text += noun
                    if j != len(item) - 1:
                        text += " and"
            elif isinstance(item, str):
                text += item
            else:
                raise TypeError(f"unexpected corpus item: {item!r}")

            if pos != len(corpus) - 1 and isinstance(corpus[pos + 1], str):
                if corpus[pos + 1] not in _NO_SPACE_BEFORE:
                    text += " "
        rendered.append(text)
    return rendered


def multiple_choice_block(question: str, options: Sequence[str]) -> str:
    """'Answer with the option's letter' block (reference `utils.py:11-26`)."""
    if len(options) != 4:
        raise ValueError(f"Expected 4 options, got {len(options)}")
    lines = "\n".join(f"{chr(65 + i)}. {opt}" for i, opt in enumerate(options))
    return f"{question}\n{lines}\nAnswer with the option's letter from the given choices directly."


def build_question(
    question: Optional[str],
    choices: Sequence[str],
    multiple_choice: bool,
    rng: random.Random,
    why_question: bool = False,
    no_image: bool = False,
) -> str:
    """Randomized question phrasing (reference `utils.py:151-175`)."""
    if why_question:
        prompt = rng.choice(WHY_QUESTIONS)
    else:
        prefix = "" if no_image else "<image>\n"
        prompt = prefix + rng.choice(QUESTION_PREFIXES) + question
    if multiple_choice:
        opts = " ".join(
            f"({ANSWER_LETTERS[i]}) {c}" for i, c in enumerate(choices)
        )
        prompt += " " + rng.choice(OPTIONS_PREFIXES) + opts
    return prompt


def build_answer(choice_idx: int, content: str, multiple_choice: bool, rng: random.Random) -> str:
    """Randomized answer phrasing (reference `utils.py:177-201`)."""
    if not multiple_choice:
        return content
    letter = ANSWER_LETTERS[choice_idx]
    content = content[0].lower() + content[1:] if content else content
    adjective = rng.choice(ANSWER_ADJECTIVES)
    punct = rng.choice(ANSWER_PUNCTUATION)
    variants = [
        f"({letter})",
        f"({letter})",
        f"{adjective} answer is ({letter})",
        f"{adjective} answer is ({letter})",
        f"({letter}){punct} {content}",
        f"({letter}){punct} {content}",
        f"{adjective} answer is ({letter}) - {content}",
        f"{adjective} answer is ({letter}) - {content}",
        f"({letter}) - {adjective} because {content}",
        f"({letter}) - {adjective} because {content}",
        f"Answer ({letter}): {content}",
        f"Answer ({letter}): {content}",
        f"Opt for ({letter}) if {content}",
        f"Opt for ({letter}) if {content}",
    ]
    return rng.choice(variants).replace("—", "-")
