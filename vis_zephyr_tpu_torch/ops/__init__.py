"""Attention, KV-cache and splice ops; the CUDA kernel wrappers and their plain versions."""
