"""The optimizers (AdamW, Adafactor) on torch tensors."""
