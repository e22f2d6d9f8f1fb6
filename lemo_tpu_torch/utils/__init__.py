"""Shared utilities: the run logger, the evaluation metrics, the host
rasterizer, the occlusion masks, the drawings (a numpy painter under
mplot3d's view), profiling and small helpers."""
