"""Sharding helpers for the model stack (one device: identities)."""
