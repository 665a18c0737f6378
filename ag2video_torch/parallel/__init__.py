"""Parallelism (port of ag2video_tpu/parallel): the JAX package's data axis
as a torch.distributed process group. Global-batch BatchNorm statistics,
gradients averaged once per optimizer step, losses and the NaN-skip
decision over the global batch; every rank feeds its own slice
(parallel/mesh.py's launch contract). The model axis is not ported."""

from ag2video_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    allreduce_grads,
    allreduce_mean,
    data_scope,
    init_distributed,
    make_mesh,
    replicate,
)
