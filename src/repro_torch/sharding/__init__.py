"""Mesh-axis names and the slicing rules of the sharded FL paths."""
