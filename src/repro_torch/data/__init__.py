"""Deterministic synthetic graph and token data (numpy)."""
