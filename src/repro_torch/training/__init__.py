"""The train step on one device."""
