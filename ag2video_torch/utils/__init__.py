"""Utilities: visualization artifacts, the metrics stream (JSONL and a
TensorBoard event file), step timing and traces, and the scene-graph
algebra (graphs.py)."""
