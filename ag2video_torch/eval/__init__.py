"""Evaluation (port of ag2video_tpu/eval): the Frechet distance, Inception
Score and feature-cache math (`fid`), PRD (`prd`), the action-distribution
metrics (`action_metrics`), the pretrained-backbone networks (`inception`,
`lpips`, `video_backbones`, channels-last on `eval.layers`), the clip
directories' video scores (`video_score`), and the synthetic-calibrated
fidelity backbone with its val-loop scorer (`backbone`)."""
