"""Synthetic stand-ins for licensed assets."""
