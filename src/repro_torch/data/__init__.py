"""Deterministic synthetic graph data (numpy)."""
