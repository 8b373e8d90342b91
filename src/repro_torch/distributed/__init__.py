"""Sharding rules and int8 gradient compression, on one device."""
