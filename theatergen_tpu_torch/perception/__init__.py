"""Perception: attention-based character detection for the
detect-and-regenerate loop."""
