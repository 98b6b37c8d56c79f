"""ViP entry point: route a dataset record to its prompt style, rewrite the
conversation text, and blend the shape overlays onto the image.

Reference: `vis_zephyr/model/vip_processor/processor.py:15-311`. Record ids
are ``{dataset}-{split}-...`` (e.g. ``vcr-train-1234``); VCR records carry a
``meta_dir`` JSON with detector ``boxes`` (last element = score, dropped)
and per-entity ``segms`` polygon lists.

Three conversation builders:
- `vcr_qa_eval`  — test-style Q→A multiple choice, constant point prompt,
- `vcr_qar_eval` — test-style QA→R rationale choice,
- `vcr_train`    — train-style Q→A then why→R with 50/50 multiple-choice
  augmentation.

The port's own copy of the JAX package's
`vis_zephyr_tpu/data/vip/processor.py`: the same code, imported without JAX
(`tests/test_torch_imports.py` holds each function to its original).
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .config import COLOR_POOL, VIP_TEST_STYLES, VIP_TRAIN_STYLES, ANSWER_LETTERS
from .draw import blend_shape
from .text import (
    assign_shapes_and_colors,
    build_answer,
    build_question,
    collect_entity_indices,
    multiple_choice_block,
    rewrite_entity_tags,
)


def _extract_segmentations(metadata: Dict, entity: int) -> Optional[List[List[float]]]:
    """Flatten an entity's polygon list, newest first, dropping degenerate
    (<4 coordinate) rings (reference `processor.py:47-56`)."""
    segs = []
    entity_segs = metadata["segms"][entity]
    for i in range(len(entity_segs) - 1, -1, -1):
        if len(entity_segs[i]) >= 4:
            segs.append(list(np.asarray(entity_segs[i], dtype=np.float64).flatten()))
    return segs or None


def vcr_qa_eval(record, assignments_rng):
    """Q→A multiple choice (reference create_question_qa_direct,
    `processor.py:79-131`)."""
    question_corpus = [record["question"]]
    answers = record["answer_choices"]
    return _vcr_direct(record, question_corpus, answers, assignments_rng, mode="qa")


def vcr_qar_eval(record, assignments_rng):
    """QA→R rationale choice (reference create_question_qar_direct,
    `processor.py:133-197`)."""
    return _vcr_direct(record, [record["question"]], record["rationale_choices"],
                       assignments_rng, mode="qar")


def _vcr_direct(record, question_corpus, choices, rng, mode):
    gold_answer = [record["answer_choices"][record["answer_label"]]]
    corpora = question_corpus + (gold_answer if mode == "qar" else []) + list(choices)
    entities = collect_entity_indices(corpora)
    assignments = assign_shapes_and_colors(
        entities, VIP_TEST_STYLES[f"vcr_{mode}"].shapes, list(COLOR_POOL.items()), rng
    )
    class_names = record.get("class_names")

    question = rewrite_entity_tags(question_corpus, assignments, class_names, rng, "direct")[0]
    rendered_choices = rewrite_entity_tags(choices, assignments, class_names, rng, "direct")

    if mode == "qa":
        prompt = "<image>\n" + multiple_choice_block(question, rendered_choices)
        reply = ANSWER_LETTERS[record["answer_label"]]
    else:
        answer = rewrite_entity_tags(gold_answer, assignments, class_names, rng, "direct")[0]
        block = multiple_choice_block("", rendered_choices)
        prompt = (
            "<image>\n"
            f'I give you a question and its answer, I need you to provide a rationale '
            f'explaining why the answer is right. "{question}" The answer is "{answer}".'
            f"What is the rationale for this decision?{block}"
        )
        reply = ANSWER_LETTERS[record["rationale_label"]]

    conversations = [
        {"from": "human", "value": prompt},
        {"from": "gpt", "value": reply},
    ]
    ordered = [assignments[e] for e in entities]
    return ordered, entities, conversations


def vcr_train(record, rng):
    """Train-style QA then why→QAR with 50/50 multiple-choice augmentation
    (reference create_question_qa_qar, `processor.py:199-311`)."""
    mc_question = rng.random() < 0.5
    mc_rationale = rng.random() < 0.5

    question_corpus = [record["question"]]
    answers = record["answer_choices"] if mc_question else [
        record["answer_choices"][record["answer_label"]]
    ]
    rationales = record["rationale_choices"] if mc_rationale else [
        record["rationale_choices"][record["rationale_label"]]
    ]

    corpora = question_corpus + list(answers) + list(rationales)
    entities = collect_entity_indices(corpora)
    assignments = assign_shapes_and_colors(
        entities, VIP_TRAIN_STYLES["vcr"].shapes, list(COLOR_POOL.items()), rng
    )
    class_names = record.get("class_names")

    question = rewrite_entity_tags(question_corpus, assignments, class_names, rng)[0]
    answers = rewrite_entity_tags(answers, assignments, class_names, rng)
    rationales = rewrite_entity_tags(rationales, assignments, class_names, rng)

    q_prompt = build_question(question, answers, mc_question, rng)
    a_idx = record["answer_label"] if mc_question else 0
    a_reply = build_answer(a_idx, answers[a_idx], mc_question, rng)

    r_prompt = build_question(None, rationales, mc_rationale, rng, why_question=True)
    r_idx = record["rationale_label"] if mc_rationale else 0
    r_reply = build_answer(r_idx, rationales[r_idx], mc_rationale, rng)

    conversations = [
        {"from": "human", "value": q_prompt},
        {"from": "gpt", "value": a_reply},
        {"from": "human", "value": r_prompt},
        {"from": "gpt", "value": r_reply},
    ]
    ordered = [assignments[e] for e in entities]
    return ordered, entities, conversations


def visual_prompt_process(
    record: Dict,
    image,
    image_size_anchor: int = 336,
    image_folder: str = "",
    visual_prompt_style: Optional[str] = None,
    alpha: Optional[int] = None,
    rng: Optional[random.Random] = None,
):
    """Main entry (reference `processor.py:15-76`): returns
    (overlaid_image, conversations)."""
    rng = rng or random.Random()
    dataset = record["id"].split("-")[0]

    if visual_prompt_style is not None:
        style = VIP_TEST_STYLES[visual_prompt_style]
    else:
        style = VIP_TRAIN_STYLES[dataset]

    if dataset != "vcr":
        raise NotImplementedError(
            f"dataset family {dataset!r}: only the VCR pipeline ships data in "
            "the reference; extend here when adding refcocog/v7w-style data"
        )

    meta_path = record["meta_dir"].replace("./dataset", image_folder)
    with open(meta_path) as f:
        metadata = json.load(f)

    if visual_prompt_style == "vcr_qa":
        assignments, entities, conversations = vcr_qa_eval(record, rng)
    elif visual_prompt_style == "vcr_qar":
        assignments, entities, conversations = vcr_qar_eval(record, rng)
    else:
        assignments, entities, conversations = vcr_train(record, rng)

    for (name, rgb, shape), entity in zip(assignments, entities):
        bbox = metadata["boxes"][entity][:-1]  # drop detector score
        segs = _extract_segmentations(metadata, entity)
        image = blend_shape(
            image, shape, bbox, segs, rgb, rng,
            image_size_anchor=image_size_anchor,
            line_style=style.line_style,
            alpha=alpha,
        )
    return image, conversations


def supports(record_id) -> bool:
    """Whether a record id belongs to a ViP-enabled dataset family
    (reference dataset routing, `train/train.py:547`)."""
    return isinstance(record_id, str) and record_id.split("-")[0] in VIP_TRAIN_STYLES
