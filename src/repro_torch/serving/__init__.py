"""Serving steps, on one device or over a mesh."""
