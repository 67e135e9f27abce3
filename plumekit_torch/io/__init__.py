"""Granule IO (numpy only)."""
