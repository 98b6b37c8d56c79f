"""Conversation history + Zephyr chat prompt templating (the port's own copy of
the JAX package's `conversation.py`).

Behavioral parity: reference `vis_zephyr/conversation.py:17-125`.
The rendered format is::

    <|system|>\n{system}</s><|user|>\n{msg}</s><|assistant|>\n{reply}</s>

with the assistant's pending turn rendered as a bare ``<|assistant|>\n``
header (no separator) so generation continues from there.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    ZEPHYR = enum.auto()
    PLAIN = enum.auto()


@dataclasses.dataclass
class Conversation:
    """An ordered multimodal chat transcript that renders to a prompt string."""

    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]] = dataclasses.field(default_factory=list)
    offset: int = 0
    separator_style: SeparatorStyle = SeparatorStyle.ZEPHYR
    separator: str = "</s>"
    version: str = "unknown"

    def get_prompt(self) -> str:
        """Render the transcript into the Zephyr chat format.

        A message of ``None`` (or empty) means "assistant's turn": only the
        role header is emitted so the model generates the reply
        (reference `conversation.py:46-59`).
        """
        messages = self.messages
        if messages and isinstance(messages[0][1], tuple):
            # First message carried an (text, image, ...) tuple: normalize so
            # "<image>" appears exactly once, at the start of the first turn
            # (reference `conversation.py:38-44`).
            messages = [list(m) for m in self.messages]
            role, payload = messages[0]
            text = payload[0].replace("<image>", "").strip()
            messages[0] = [role, "<image>\n" + text]

        if self.separator_style is SeparatorStyle.ZEPHYR:
            parts = [f"<|system|>\n{self.system}{self.separator}"]
            for role, message in messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    parts.append(f"<|{role}|>\n{message}{self.separator}")
                else:
                    parts.append(f"<|{role}|>\n")
            return "".join(parts)
        if self.separator_style is SeparatorStyle.PLAIN:
            # Pretrain style: raw messages joined by the separator, no role
            # headers (used only through `preprocess_pretrain`).
            parts = []
            for _, message in messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    parts.append(message + self.separator)
                else:
                    parts.append("")
            return "".join(parts)
        raise ValueError(f"Unknown separator style: {self.separator_style}")

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            separator_style=self.separator_style,
            separator=self.separator,
            version=self.version,
        )


conv_zephyr_v1 = Conversation(
    system=(
        "You are an AI assistant specialized in Visual Commonsense Reasoning "
        "and able to understand the visual content that the user provides.\n"
        "Given an image and a question, your task is to provide an accurate "
        "answer, followed by a concise, logical explanation of your reasoning "
        "based on visual cues and common sense. Your response must clearly "
        "separate the answer and the explanation."
    ),
    roles=("user", "assistant"),
    version="zephyr_v1",
)

conv_zephyr_vcr = Conversation(
    system=(
        "You are an AI assistant specialized in Visual Commonsense Reasoning. "
        "Your task is to analyze the provided visual content along with a "
        "question. Subsequently, select the most appropriate answer from the "
        "given choices. Your answer must be in the format "
        "'Answer is: {A, B, C or D}'."
    ),
    roles=("user", "assistant"),
    version="zephyr_vcr",
)

conv_zephyr_plain = Conversation(
    system="",
    roles=("", ""),
    separator_style=SeparatorStyle.PLAIN,
    version="plain",
)

default_conversation = conv_zephyr_v1

templates = {
    "default": conv_zephyr_v1,
    "zephyr_v1": conv_zephyr_v1,
    "zephyr_vcr": conv_zephyr_vcr,
    "plain": conv_zephyr_plain,
}
