"""The benchmark of ag2video_torch on one NVIDIA H100 (see README.md)."""
