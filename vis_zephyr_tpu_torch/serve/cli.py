"""Interactive single-image chat CLI (PyTorch port of
`vis_zephyr_tpu/serve/cli.py`): load the model, preprocess the image once,
read user turns and stream each reply."""

from __future__ import annotations

import argparse

import torch

from ..models.builder import load_pretrained_model
from .engine import ChatEngine


def load_image(image_file: str):
    from PIL import Image

    return Image.open(image_file).convert("RGB")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Vis-Zephyr chat CLI (PyTorch)")
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-base", default=None)
    p.add_argument("--vision-tower", default=None)
    p.add_argument("--image-file", required=True)
    p.add_argument("--conv-mode", default="zephyr_v1")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max-new-tokens", type=int, default=512)
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    tokenizer, model, cfg, _ = load_pretrained_model(
        args.model_path, model_base=args.model_base, vision_tower_path=args.vision_tower,
        dtype=torch.bfloat16, device="cuda",
    )
    if tokenizer is None:
        raise SystemExit("could not load a tokenizer; pass --model-base or a "
                         "--model-path with tokenizer files")
    engine = ChatEngine(model, cfg, tokenizer, conv_mode=args.conv_mode,
                        temperature=args.temperature, max_new_tokens=args.max_new_tokens)
    image = load_image(args.image_file)
    first = True
    print("Loaded. Type your message (ctrl-d to exit).")
    while True:
        try:
            question = input("user: ")
        except EOFError:
            break
        if not question.strip():
            continue
        print("assistant: ", end="", flush=True)
        for chunk in engine.chat("cli", question, pil_image=image if first else None):
            print(chunk, end="", flush=True)
        print()
        first = False


if __name__ == "__main__":
    main()
