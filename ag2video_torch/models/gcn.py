"""Scene-graph triple convolution (port of ag2video_tpu/models/gcn.py).

concat [s_vec, p_vec, o_vec] -> net1 -> subject / predicate / object
messages; messages are pooled per object node through one-hot endpoint
matrices (padded triplets masked by `indicators`), averaged over the
endpoint count clipped at 1, then -> net2.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ag2video_torch.models.layers import MLP


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives an all-zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


class GraphTripleConv(nn.Module):
    """net1: [2*obj_in + pred_in] -> hidden -> [2*hidden + pred_out];
    net2: hidden -> hidden -> obj_out; both end in relu, kaiming init."""

    def __init__(self, obj_in: int, pred_in: int, object_output_dim: int,
                 predicate_output_dim: int, hidden_dim: int,
                 pooling: str = "avg", dtype: Optional[torch.dtype] = None):
        super().__init__()
        if pooling not in ("avg", "sum"):
            raise ValueError(f'Invalid pooling "{pooling}"')
        H = hidden_dim
        self.H, self.Dp_out, self.pooling = H, predicate_output_dim, pooling
        self.net1 = MLP(2 * obj_in + pred_in,
                        [H, 2 * H + predicate_output_dim], init_scale=2.0,
                        dtype=dtype)
        self.net2 = MLP(H, [H, object_output_dim], init_scale=2.0,
                        dtype=dtype)

    def forward(self, obj_vecs: torch.Tensor, pred_vecs: torch.Tensor,
                edges: torch.Tensor, indicators: torch.Tensor):
        """obj_vecs (B, O, Din), pred_vecs (B, E, Dp), edges (B, E, 2) int,
        indicators (B, E) -> (new_obj_vecs (B, O, obj_out),
        new_pred_vecs (B, E, pred_out))."""
        O = obj_vecs.shape[1]
        H, Dp = self.H, self.Dp_out
        s_idx, o_idx = edges[..., 0].long(), edges[..., 1].long()
        D = obj_vecs.shape[-1]
        cur_s = torch.gather(obj_vecs, 1, s_idx[..., None].expand(-1, -1, D))
        cur_o = torch.gather(obj_vecs, 1, o_idx[..., None].expand(-1, -1, D))

        new_t = self.net1(torch.cat([cur_s, pred_vecs, cur_o], dim=-1))
        new_s = new_t[..., :H]
        new_p = new_t[..., H:H + Dp]
        new_o = new_t[..., H + Dp:]

        ind = indicators.to(new_s.dtype)[..., None]
        oh_s = one_hot(s_idx, O, new_s.dtype) * ind
        oh_o = one_hot(o_idx, O, new_s.dtype) * ind
        pooled = torch.einsum("beo,beh->boh", oh_s.float(), new_s.float())
        pooled = pooled + torch.einsum("beo,beh->boh", oh_o.float(),
                                       new_o.float())
        pooled = pooled.to(new_s.dtype)
        if self.pooling == "avg":
            counts = oh_s.sum(1) + oh_o.sum(1)  # (B, O)
            pooled = pooled / torch.clamp(counts, min=1.0)[..., None]
        return self.net2(pooled), new_p
