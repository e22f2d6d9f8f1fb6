"""Geometry and signal helpers on torch tensors."""
