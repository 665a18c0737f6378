"""Host-side data: fixed-shape collation, the clip transforms and the host
library under them, the PNG frame reader, the synthetic, CATER and
Something-Else datasets, the dataset registry and its threaded loader."""

from ag2video_torch.data.collate import Batch, collate  # noqa: F401
from ag2video_torch.data.registry import Loader, get_dataset  # noqa: F401
