"""Atomic, async, retention-managed checkpoints."""
