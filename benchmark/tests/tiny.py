"""Cells at a size the CPU runs in seconds: the benchmark's configurations
with every width cut and 32x32 frames, for the CPU tests."""

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

SMALL = dict(image_size=[32, 32], ngf=4, nff=4, n_blocks_F=1,
             n_downsample_F=2, embedding_dim=16, gconv_dim=16,
             gconv_hidden_dim=32)


def load(rel):
    with open(os.path.join(BENCH, rel)) as f:
        return json.load(f)


def config(name="cater256_factorized", dtype="float32", **kw):
    c = load(f"configs/{name}.json")
    c = copy.deepcopy(c)
    c["model"].update(SMALL, compute_dtype=dtype, **kw)
    return c


def traffic(loop="throughput", batch=2, **kw):
    t = dict(driver="generate", frames=4, max_objects=5, max_triplets=5,
             max_actions=2, image_size=[32, 32], batch=batch, ring=2,
             loop=loop, warmup=1, check_calls=2, ref_block=2, span_calls=1,
             trace_calls=1)
    t.update(kw)
    return t


def cell(cfg=None, trf=None, limits=None, per_layer=(), end_to_end=()):
    return {"name": "tiny", "entry": {"chips": 1},
            "config": cfg or config(), "traffic": trf or traffic(),
            "limits": limits or {"frames_gap_x_bf16": 0.1,
                                "boxes_err": 1e-4},
            "end_to_end": list(end_to_end), "per_layer": list(per_layer)}
