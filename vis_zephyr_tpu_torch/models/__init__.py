"""CLIP tower, fusion, Q-Former, Mistral decoder and the multimodal model."""
