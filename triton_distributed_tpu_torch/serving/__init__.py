"""Serving runtime (the decode step shared with Engine)."""
