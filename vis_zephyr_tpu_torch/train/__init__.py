"""Training: the two-stage trainer, its steps, optimizer, LoRA and checkpoints."""
