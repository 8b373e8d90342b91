"""Serving steps on one device."""
