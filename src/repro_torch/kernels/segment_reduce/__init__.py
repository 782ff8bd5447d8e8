"""Segment sum: the engine's one reduction primitive (float64, ordered)."""
