"""Checkpoint save and load with `torch.save`, in the JAX package's layout.

Port of `vis_zephyr_tpu/train/checkpoints.py`, which writes with orbax (the
card's machine has none). The layout is the same:
- `checkpoint-{step}/projector/projector.pt`: the projector's state dict
  only (the stage-1 artifact, "mm_projector.bin" equivalent);
- `checkpoint-{step}/state/state.pt`: the full train state, as the JAX one
  holds it: {"params": the model's state dict, "opt_state": the optimizer's,
  "step"};
- `checkpoint-{step}/trainer_state.json`: step metadata.
`latest_checkpoint` mirrors HF's get_last_checkpoint discovery. A directory
that orbax wrote is refused by name, as `models/builder.py` refuses one.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import torch

_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt")


def _ckpt_dir(output_dir: str, step: int) -> str:
    return os.path.join(output_dir, f"checkpoint-{step}")


def save_checkpoint(
    output_dir: str,
    state: Dict,
    step: int,
    projector_only: bool = False,
    metadata: Optional[Dict] = None,
) -> str:
    """Write `checkpoint-{step}/` under output_dir; `state` is the train state
    of `train/steps.py` ({"params": model, "opt_state": optimizer, "step"})."""
    path = _ckpt_dir(output_dir, step)
    if projector_only:
        os.makedirs(os.path.join(path, "projector"), exist_ok=True)
        torch.save(state["params"].projector.state_dict(),
                   os.path.join(path, "projector", "projector.pt"))
    else:
        os.makedirs(os.path.join(path, "state"), exist_ok=True)
        torch.save({"params": state["params"].state_dict(),
                    "opt_state": state["opt_state"].state_dict(),
                    "step": state["step"]},
                   os.path.join(path, "state", "state.pt"))
    meta = {"step": step, "projector_only": projector_only}
    meta.update(metadata or {})
    with open(os.path.join(path, "trainer_state.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def latest_checkpoint(output_dir: str, full_state: bool = False) -> Optional[str]:
    """Newest checkpoint dir; with `full_state=True`, the newest one that
    carries a resumable full state (skipping projector-only saves)."""
    if not os.path.isdir(output_dir):
        return None
    steps = []
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    for step in sorted(steps, reverse=True):
        path = os.path.join(output_dir, f"checkpoint-{step}")
        if not full_state or os.path.isdir(os.path.join(path, "state")):
            return path
    return None


def state_form(folder: str) -> Optional[str]:
    """"torch" for a folder this module wrote (`<name>.pt` inside, named
    after the folder), "orbax" for one orbax wrote, None otherwise."""
    name = os.path.basename(os.path.normpath(folder))
    if os.path.exists(os.path.join(folder, f"{name}.pt")):
        return "torch"
    if any(os.path.exists(os.path.join(folder, marker)) for marker in _ORBAX_MARKERS):
        return "orbax"
    return None


def _file(path: str, part: str) -> str:
    """`path/part/part.pt`, or a refusal of a directory orbax wrote."""
    folder = os.path.join(path, part)
    found = os.path.join(folder, f"{part}.pt")
    if state_form(folder) == "orbax":
        raise NotImplementedError(
            f"{folder} is an orbax checkpoint; the PyTorch port reads only the "
            f"torch.save layout ({part}/{part}.pt) it writes itself")
    return found


def load_checkpoint(path: str, target_state: Dict) -> Dict:
    """Restore a full-state checkpoint into `target_state` (its model and
    optimizer, in place); returns it with the saved step."""
    model = target_state["params"]
    saved = torch.load(_file(path, "state"), map_location=next(model.parameters()).device,
                       weights_only=True)
    model.load_state_dict(saved["params"], strict=True)
    target_state["opt_state"].load_state_dict(saved["opt_state"])
    target_state["step"] = int(saved["step"])
    return target_state


def load_projector(path: str, target_projector: torch.nn.Module) -> torch.nn.Module:
    """Restore a projector-only checkpoint into `target_projector`, in place
    (stage-1 resume / stage-2 init, reference `train/train.py:870-893`)."""
    device = next(target_projector.parameters()).device
    target_projector.load_state_dict(
        torch.load(_file(path, "projector"), map_location=device, weights_only=True),
        strict=True)
    return target_projector


def checkpoint_meta(path: str) -> Dict:
    with open(os.path.join(path, "trainer_state.json")) as f:
        return json.load(f)
