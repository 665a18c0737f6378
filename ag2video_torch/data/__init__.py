"""Host-side data: fixed-shape collation, the image normalisation, the
synthetic dataset, the dataset registry and its threaded loader. Not ported
yet: the CATER and Something-Else loaders and their clip transforms, whose
data files are not in the repository (ROADMAP)."""

from ag2video_torch.data.collate import Batch, collate  # noqa: F401
from ag2video_torch.data.registry import Loader, get_dataset  # noqa: F401
