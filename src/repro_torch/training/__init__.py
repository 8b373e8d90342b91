"""The train step, on one device or over a mesh."""
