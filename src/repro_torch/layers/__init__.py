"""Layers of the dense decoder."""
