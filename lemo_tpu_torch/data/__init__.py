"""Data helpers: marker sets, body segments, statistics, representations."""
