"""Shared utilities: the run logger, the evaluation metrics, the host
rasterizer, the occlusion masks, the matplotlib drawings, profiling and
small helpers."""
