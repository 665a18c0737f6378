"""Command-line entry points of the port (`python -m
ag2video_torch.scripts.<name>`)."""
