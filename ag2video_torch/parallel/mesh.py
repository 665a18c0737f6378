"""The data axis as a torch.distributed process group (port of
ag2video_tpu/parallel/mesh.py).

Launch contract
---------------
One process per card, started by `torchrun` (or any launcher that sets
torch's standard variables RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT). `init_distributed` joins the group: NCCL for a CUDA device,
gloo for the CPU. Then, as under the JAX package's multi-host contract:

1. Compute: every rank holds the whole model (`replicate` broadcasts rank
   0's parameters, buffers and optimizer state, then checks that the ranks
   agree). Inside `data_scope(mesh)` the train-mode BatchNorm takes its
   statistics over the global batch (`AllReduceSum` of the per-rank sums;
   models/normalization.py), and after each backward the trainer averages
   each network's gradients with one all-reduce (`allreduce_grads`). The
   JAX package gets both from XLA's collectives on a jitted step over the
   mesh; here they are explicit.
2. Input: each rank feeds only its own slice of the global batch, from
   `Loader(host_index=rank, host_count=world)`, so there is no twin of the
   JAX `shard_batch`: nothing here places or splits a batch.

Only `all_reduce` and `broadcast` are used: gloo on CUDA tensors offers
nothing else. The model axis (the JAX package's spatial sharding) is not
ported; `make_mesh(model > 1)` raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import logging
import os
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

log = logging.getLogger(__name__)

# torch's launcher variables (as torchrun sets them).
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: its process group, this process's rank in it and its
    size."""
    group: dist.ProcessGroup
    rank: int
    world: int


def process_index() -> int:
    """This process's global rank, 0 without a process group (the twin of
    `jax.process_index`): host-side writes are rank 0's."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(device: Optional[Union[str, torch.device]] = None,
                     backend: Optional[str] = None
                     ) -> Optional[torch.device]:
    """Join the process group torch's launcher variables describe -> this
    rank's device; a strict no-op (None) when none of them is set.

    device: default `cuda:{LOCAL_RANK}`; the backend is NCCL for a CUDA
    device and gloo for the CPU, unless `backend` names one (gloo on the
    card: two ranks that share one card). A partial set of the variables
    raises, naming what is missing. A failure to initialise the backend is
    not caught: nothing falls back to another backend or to the CPU."""
    present = [k for k in LAUNCH_VARS if os.environ.get(k)]
    if not present:
        return None
    missing = [k for k in LAUNCH_VARS if k not in present]
    if missing:
        raise RuntimeError(
            f"{', '.join(present)} set but {', '.join(missing)} missing: a "
            f"distributed launch needs all of {', '.join(LAUNCH_VARS)}")
    device = torch.device(f"cuda:{int(os.environ['LOCAL_RANK'])}"
                          if device is None else device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device  # initialise NCCL now, not lazily
    dist.init_process_group(backend, init_method="env://", **kw)
    log.info("torch.distributed initialised: rank %d of %d, backend %s, "
             "device %s", dist.get_rank(), dist.get_world_size(), backend,
             device)
    return device


def make_mesh(model: int = 1) -> Mesh:
    """The data axis over the whole world. The model axis is not ported:
    model > 1 raises."""
    if model != 1:
        raise NotImplementedError(
            f"model axis {model}: spatial sharding over a model axis is not "
            "ported (ROADMAP.md, 'Model-axis spatial sharding')")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "init_distributed (or init_process_group) first")
    group = dist.group.WORLD
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group))


_SCOPE: contextvars.ContextVar = contextvars.ContextVar("data_scope",
                                                        default=None)


@contextlib.contextmanager
def data_scope(mesh: Optional[Mesh]):
    """Inside the block, train-mode BatchNorms take their statistics over
    `mesh`'s data axis (None: no scope). Scoped, not global, so that two
    Trainers in one process stay independent."""
    token = _SCOPE.set(mesh)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def current_data_group() -> Optional[dist.ProcessGroup]:
    """The data axis's group of the innermost `data_scope`, or None outside
    one or at world 1."""
    mesh = _SCOPE.get()
    return mesh.group if mesh is not None and mesh.world > 1 else None


def _on_backend(t: torch.Tensor, group) -> torch.Tensor:
    """`t`, or a copy on the current card when the backend is NCCL and `t`
    lies on the CPU (an Adam's step count)."""
    if t.device.type != "cuda" and dist.get_backend(group) == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


class AllReduceSum(torch.autograd.Function):
    """SUM over the group forward, and SUM of the incoming gradients
    backward: the gradient of a sum over ranks reaches every rank's
    input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def allreduce_grads(params: Iterable[torch.Tensor], mesh: Mesh) -> int:
    """Average the `.grad` of `params` over the data axis: one flat fp32
    buffer, one SUM all-reduce, divided by the world size, copied back into
    each `.grad` (bf16 gradients of bf16 params are summed in fp32 and
    rounded once) -> bytes all-reduced. Parameters without a gradient are
    left out; every rank has the same ones (the same graph)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return 0
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world)
    i = 0
    with torch.no_grad():
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view(g.shape))
            i += g.numel()
    return flat.numel() * flat.element_size()


def allreduce_mean(tensors: Sequence[torch.Tensor], mesh: Mesh
                   ) -> List[torch.Tensor]:
    """The means over the data axis of scalar `tensors` (detached, fp32),
    in one all-reduce."""
    if not tensors:
        return []
    flat = torch.stack([t.detach().float().reshape(()) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    return list((flat / mesh.world).unbind())


def allreduce_sum_array(x: np.ndarray, mesh: Mesh,
                        device: torch.device) -> np.ndarray:
    """The sum over the data axis of a host array (reduced on `device`)."""
    t = _on_backend(torch.from_numpy(np.ascontiguousarray(x)).to(device),
                    mesh.group)
    dist.all_reduce(t, group=mesh.group)
    return t.cpu().numpy()


def gather_rows(x: np.ndarray, mesh: Mesh, device: torch.device
                ) -> List[np.ndarray]:
    """Every rank's rows of the 2-D array `x` (the same dtype on every
    rank, any number of rows; a rank with none may pass shape (0, 0)), in
    rank order: one MAX all-reduce of the row counts and the width, one SUM
    all-reduce of a rank-slotted, zero-padded buffer (x + 0 is x, so the
    rows come back exact)."""
    shape = np.zeros(mesh.world + 1, np.int64)
    shape[mesh.rank], shape[-1] = x.shape
    t = _on_backend(torch.from_numpy(shape).to(device), mesh.group)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    counts, width = t[:-1].tolist(), int(t[-1])
    buf = np.zeros((mesh.world, max(counts), width), x.dtype)
    buf[mesh.rank, :len(x)] = x
    buf = allreduce_sum_array(buf, mesh, device)
    return [buf[r, :n] for r, n in enumerate(counts)]


def gather_in_split_order(x: np.ndarray, rows_per_sample: int, mesh: Mesh,
                          device: torch.device) -> np.ndarray:
    """`gather_rows` of `x`, `rows_per_sample` rows per sample, in the
    order one process reads the split: rank r's k-th sample is the split's
    sample r + world * k (the Loader's unshuffled index stride)."""
    parts = [p.reshape(-1, rows_per_sample, p.shape[-1])
             for p in gather_rows(x, mesh, device)]
    rows = [p[k] for k in range(max(len(p) for p in parts))
            for p in parts if k < len(p)]
    return np.concatenate(rows) if rows else parts[0].reshape(0, -1)


def state_tensors(obj: Union[nn.Module, torch.optim.Optimizer]
                  ) -> List[torch.Tensor]:
    """Every tensor of a module (parameters and buffers) or of an optimizer
    (its own parameters, the fp32 masters of a ScheduledAdam among them,
    and its state), in a fixed order."""
    if isinstance(obj, nn.Module):
        return list(obj.state_dict(keep_vars=True).values())
    out = [p for g in obj.param_groups for p in g["params"]]
    for p in out[:]:
        out.extend(v for _, v in sorted(obj.state.get(p, {}).items())
                   if torch.is_tensor(v))
    return out


def replicate(obj: Union[nn.Module, torch.optim.Optimizer], mesh: Mesh):
    """Broadcast every tensor of `obj` (a module's parameters and buffers,
    or an optimizer's parameters and state) from rank 0, then check that
    the ranks agree -> obj."""
    tensors = state_tensors(obj)
    with torch.no_grad():
        for t in tensors:
            buf = _on_backend(t.data, mesh.group)
            dist.broadcast(buf, src=0, group=mesh.group)
            if buf is not t.data:
                t.data.copy_(buf)
    differ = replicas_differ(tensors, mesh)
    if differ:
        raise RuntimeError(f"replicate: {len(differ)} tensors differ "
                           f"across ranks after the broadcast")
    return obj


def checksums(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """(len(tensors), 2) int64: per tensor the sum of its elements' bit
    patterns and their sum weighted by position (mod 65521), so that equal
    checksums mean equal bits but for a collision."""
    out = []
    for t in tensors:
        bits = t.detach().contiguous().reshape(-1)
        bits = bits.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[bits.element_size()]) \
            .to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append(torch.stack([bits.sum(), (bits * w).sum()]))
    if not out:
        return torch.zeros((0, 2), dtype=torch.int64)
    return torch.stack([o.to(out[0].device) for o in out])


def replicas_differ(tensors: Sequence[torch.Tensor], mesh: Mesh
                    ) -> List[int]:
    """The indices of `tensors` whose bits differ between ranks: one
    all-reduce of MAX over each tensor's checksums and their negation (the
    MAX equals minus the MAX of the negation only where every rank's
    checksum is the same)."""
    c = checksums(tensors)
    both = _on_backend(torch.cat([c, -c], 1), mesh.group)
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
    hi, neg_lo = both[:, :2], both[:, 2:]
    return [int(i) for i in torch.nonzero((hi != -neg_lo).any(1)).flatten()]
