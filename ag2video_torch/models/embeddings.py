"""Attribute embeddings (port of ag2video_tpu/models/embeddings.py).

One table per attribute family, concatenated, then a shared FC
(`attribute_fc_gen`) when there is more than one family or when
`use_attr_fc_gen` forces it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ag2video_torch.models.layers import Dense, Embed


class AttributeEmbeddings(nn.Module):
    """objs (..., O, A) integer attribute ids -> (..., O, A * embedding_dim).

    `cardinalities` maps family -> table size, in the objs column order.
    """

    def __init__(self, cardinalities: Dict[str, int], embedding_dim: int,
                 dtype: Optional[torch.dtype] = None,
                 use_attr_fc_gen: bool = False):
        super().__init__()
        families = list(cardinalities)
        self.n_families = len(families)
        for k, fam in enumerate(families):
            setattr(self, f"att_emb_{k}",
                    Embed(cardinalities[fam], embedding_dim, dtype))
        width = len(families) * embedding_dim
        self.attribute_fc_gen = (
            Dense(width, width, dtype=dtype)
            if len(families) > 1 or use_attr_fc_gen else None)

    def forward(self, objs: torch.Tensor) -> torch.Tensor:
        if objs.shape[-1] != self.n_families:
            raise ValueError(f"objs has {objs.shape[-1]} attribute columns, "
                             f"expected {self.n_families}")
        out = torch.cat([getattr(self, f"att_emb_{k}")(objs[..., k])
                         for k in range(self.n_families)], dim=-1)
        if self.attribute_fc_gen is not None:
            out = self.attribute_fc_gen(out)
        return out
