"""Loss and train step, PyTorch.

Port of `vis_zephyr_tpu/train/steps.py`: multimodal forward (frozen tower,
Q-Former projection, splice, decoder with remat) → shifted cross-entropy
over non-IGNORE labels → gradients of the trainable parameters → the
optimizer (`train/optimizer.py::TrainOptimizer`). On a CUDA device the
decoder's attention runs K1 forward (twice under remat) and K7 + K8 backward.

The JAX train state `{"params", "opt_state", "step"}` is here `{"params":
the model, "opt_state": its TrainOptimizer, "step": micro-steps taken}`;
`train_step` updates it in place and returns it.

Reference equivalents: the HF Trainer loop driven from
`vis_zephyr/train/train.py:849-893`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import VisZephyrConfig
from ..constants import IGNORE_INDEX
from ..models.mistral import fold_seed
from ..models.vis_zephyr import VisZephyr, vis_zephyr_forward
from .optimizer import TrainOptimizer, global_norm


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE over positions whose *target* label != IGNORE_INDEX.

    logits [B, T, V], labels [B, T] (already aligned to the spliced
    sequence). Returns (mean loss over the batch's valid targets, their
    count); f32 log-softmax."""
    targets = labels[:, 1:]
    preds = logits[:, :-1]
    valid = targets != IGNORE_INDEX
    safe = targets.clamp(min=0)
    logp = torch.log_softmax(preds.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    n = valid.sum()
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / n.clamp(min=1)
    return loss, n


def loss_fn(model: VisZephyr, batch: Dict[str, torch.Tensor], cfg: VisZephyrConfig,
            remat: bool = True, lora_dropout: float = 0.0, dropout_rng: Optional[int] = None):
    """(loss, {"loss", "tokens"}) of one batch (`Collator` output, as tensors)."""
    if "merge_info" in batch:
        raise NotImplementedError("spatial patch merge (merge_info) is not ported yet "
                                  "(ROADMAP.md, Queue A steps 2 and 3)")
    logits, aux = vis_zephyr_forward(
        model, batch["input_ids"], batch.get("images"), batch.get("patch_valid"), cfg,
        text_valid=batch.get("text_valid"), labels=batch["labels"], remat=remat,
        lora_dropout=lora_dropout, dropout_rng=dropout_rng,
    )
    loss, n_tokens = cross_entropy(logits, aux["labels"])
    return loss, {"loss": loss, "tokens": n_tokens}


def make_train_step(model: VisZephyr, cfg: VisZephyrConfig, optimizer: TrainOptimizer,
                    remat: bool = True, trainable: Optional[Dict[str, bool]] = None,
                    lora_dropout: float = 0.0, dropout_seed: int = 0):
    """Returns `train_step(state, batch) -> (state, metrics)` with metrics
    `loss`, `tokens` and `grad_norm` (device tensors, not synchronized).

    Gradients are taken of `optimizer.params` only, the parameters with
    `requires_grad` (set from `trainable_mask` when the optimizer was built;
    `trainable`, if given, must agree): frozen ones get no `.grad`, and
    grad_norm is the global norm of the trainable gradients of this call, as
    the JAX step's `optax.global_norm` of its masked grads.

    `lora_dropout` > 0 drops each LoRA branch's input with masks seeded from
    (`dropout_seed`, the step counter, layer, projection), so a resumed run
    replays the same masks and the recompute under remat draws the same."""
    if trainable is not None:
        named = dict(model.named_parameters())
        if [id(named[n]) for n, t in trainable.items() if t] != list(map(id, optimizer.params)):
            raise ValueError("`trainable` disagrees with the optimizer's parameters")

    def train_step(state: Dict, batch: Dict[str, torch.Tensor]):
        rng = fold_seed(dropout_seed, state["step"]) if lora_dropout > 0.0 else None
        loss, metrics = loss_fn(model, batch, cfg, remat=remat, lora_dropout=lora_dropout,
                                dropout_rng=rng)
        # A parameter this batch does not reach (the projector on a text-only
        # batch) gets a zero gradient, as under jax.grad.
        grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True,
                                    materialize_grads=True)
        metrics = {"loss": loss.detach(), "tokens": metrics["tokens"],
                   "grad_norm": global_norm(grads)}
        optimizer.update(grads)
        state["step"] += 1
        return state, metrics

    return train_step


def init_train_state(model: VisZephyr, optimizer: TrainOptimizer) -> Dict:
    return {"params": model, "opt_state": optimizer, "step": 0}
