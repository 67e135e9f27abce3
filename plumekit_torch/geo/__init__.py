"""Geodesy helpers (numpy only)."""
