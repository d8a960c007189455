"""Shared utilities (padding math, structured solve records)."""
