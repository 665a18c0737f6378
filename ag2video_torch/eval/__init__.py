"""Evaluation (port of ag2video_tpu/eval): the Frechet distance and
Inception-Score math (`fid`), and the synthetic-calibrated fidelity
backbone with its val-loop scorer (`backbone`)."""
