"""Sharding rules of the port's data-parallel path (rules.py)."""
