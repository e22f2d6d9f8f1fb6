"""Shared utilities: the run logger and the evaluation metrics."""
