"""Evaluation harnesses: VCR (ViP-overlaid multiple choice) and MMBench, on
the port's model (`python -m vis_zephyr_tpu_torch.eval.eval_vqa`,
`...eval.eval_mmbench`)."""
