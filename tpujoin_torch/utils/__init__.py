"""Shape, timing and device helpers."""
