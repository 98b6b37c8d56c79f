"""Host-side data preparation."""
