"""Data pipelines: synthetic GLENDA-like frames and hospital splits."""
