"""The plain reference, held on the CPU in fp32: against the program with
the same weights, against the JAX package's stored outputs (read from
their file; no JAX import), and its FLOP count against the program's."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import flops, inputs, weights
from benchmark.drivers import generate as gen
from benchmark.reference.generation import AG2VideoReference
from benchmark.tests import tiny

STORED = os.path.join(tiny.BENCH, os.pardir, "torch_tools", "data",
                      "reference_factorized_32.npz")


def _port(cfg, trf, seed):
    from ag2video_torch.models import AG2VideoModel

    pcfg, vocab = gen.port_config(cfg, trf)
    model = AG2VideoModel(pcfg, vocab, device="cpu")
    model.load_state_dict(weights.make_state(gen.reference_spec(cfg), seed,
                                             "cpu"))
    return model


def _ref(cfg, seed, prec=None):
    ref = AG2VideoReference(cfg, prec)
    ref.load_state_dict(weights.make_state(gen.reference_spec(cfg), seed,
                                           "cpu"))
    return ref


def _args(b):
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    return (t["imgs"], t["objs"], t["triplets"], t["actions"], t["boxes"])


@pytest.mark.parametrize("factorized", [True, False],
                         ids=["factorized", "dense"])
@pytest.mark.parametrize("size", [32, 64])
def test_reference_matches_the_port_in_fp32(factorized, size):
    from ag2video_torch.inference import generate

    cfg = tiny.config(factorized_frontend=factorized,
                      image_size=[size, size])
    trf = tiny.traffic(image_size=[size, size])
    b = inputs.make_ring(cfg["vocab"], trf, 5)[0]
    imgs, boxes = generate(_port(cfg, trf, 9), b)
    with torch.no_grad():
        ri, rb = _ref(cfg, 9)(*_args(b))
    fe, be = gen.clip_errors(imgs, boxes, ri, rb, 1)
    assert max(fe) < 1e-5 and max(be) < 1e-6


def test_reference_reproduces_the_jax_package_stored_outputs():
    """The JAX package's outputs of a small default-config model, stored
    with its variables and inputs; the variables reach the reference by
    the program's weight bridge (names only: each tensor is copied)."""
    from ag2video_torch import Config, get_vocab
    from ag2video_torch.flax_npz import unflatten_variables
    from ag2video_torch.models import AG2VideoModel
    from ag2video_torch.weights import from_flax

    with np.load(STORED) as z:
        arrays = {k: z[k] for k in z.files}
    pcfg = Config.from_dict(json.loads(str(arrays.pop("config"))))
    vocab = get_vocab(pcfg.dataset)
    flat = {k: v for k, v in arrays.items()
            if k.split("/")[0] in ("params", "batch_stats", "spectral")}
    port = from_flax(unflatten_variables(flat),
                     AG2VideoModel(pcfg, vocab, device="cpu"))
    cfg = tiny.config()
    d = pcfg.to_dict()
    cfg["model"] = {k: d[k] for k in cfg["model"]}
    ref = AG2VideoReference(cfg)
    ref.load_state_dict(port.state_dict())
    inp = {k.split("/")[1]: v for k, v in arrays.items()
           if k.startswith("input/")}
    want = {k.split("/")[1]: v for k, v in arrays.items()
            if k.startswith("output/")}
    with torch.no_grad():
        imgs, boxes = ref(*_args(inp))
    np.testing.assert_allclose(imgs.numpy(), want["imgs_pred"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(boxes.numpy(), want["boxes_pred"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factorized", [True, False],
                         ids=["factorized", "dense"])
def test_flop_count_matches_the_port_and_is_linear_in_batch(factorized):
    from torch.utils.flop_counter import FlopCounterMode

    from ag2video_torch.inference import generate

    cfg = tiny.config(factorized_frontend=factorized)
    counts = {}
    for B in (1, 2, 4):
        trf = tiny.traffic(batch=B)
        b = inputs.make_ring(cfg["vocab"], trf, 1)[0]
        counts[B] = flops.model_flops(AG2VideoReference, cfg, b)
    # Linear in B, plus the spectral power iterations, one per kernel and
    # frame whatever B (under 1% of a clip).
    per_clip = counts[2] - counts[1]
    assert counts[4] - counts[2] == 2 * per_clip
    assert 0 <= counts[1] - per_clip < 1e-2 * per_clip
    trf = tiny.traffic(batch=2)
    b = inputs.make_ring(cfg["vocab"], trf, 1)[0]
    port = _port(cfg, trf, 3)
    generate(port, b)       # caches the spectral kernels, as a window's
    with FlopCounterMode(display=False) as fc:
        generate(port, b)
    # The reference also counts one power iteration per kernel per frame,
    # which the program caches: matrix-vector products, under 1%.
    assert counts[2] == pytest.approx(fc.get_total_flops(), rel=1e-2)
    assert counts[2] >= fc.get_total_flops()


def test_seeded_weights_and_inputs_repeat_and_differ():
    cfg = tiny.config()
    spec = gen.reference_spec(cfg)
    big = 2 ** 31 + 12345
    a = weights.make_state(spec, big, "cpu")
    b = weights.make_state(spec, big, "cpu")
    c = weights.make_state(spec, big + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    trf = tiny.traffic()
    r1 = inputs.make_ring(cfg["vocab"], trf, big)
    r2 = inputs.make_ring(cfg["vocab"], trf, big)
    r3 = inputs.make_ring(cfg["vocab"], trf, -7)
    assert all(np.array_equal(r1[0][k], r2[0][k]) for k in r1[0])
    assert not np.array_equal(r1[0]["imgs"], r1[1]["imgs"])
    assert all(r1[0][k].shape == r3[0][k].shape for k in r1[0])
