"""Sharding rules, placement on a mesh, and int8 gradient compression."""
