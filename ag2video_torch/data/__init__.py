"""Host-side data: fixed-shape collation and the image normalisation that
generation needs. The dataset loaders are not ported yet (ROADMAP)."""

from ag2video_torch.data.collate import Batch, collate  # noqa: F401
