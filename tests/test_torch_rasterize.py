"""The port's box rasterizer (ag2video_torch/ops/rasterize.py) against the JAX
package: the plain version against the Pallas kernel in interpret mode and
against the XLA closed form, at 1e-5, on inputs made from a numpy seed.
The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from ag2video_tpu.ops import rasterize as jr
from ag2video_torch.ops import rasterize as tr
from torch_tools.kernel_checks import BF16_TOL

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, N, O, D):
    vecs = rng.randn(N, O, D).astype(np.float32)
    boxes = np.stack([
        rng.uniform(-0.2, 0.9, (N, O)),
        rng.uniform(-0.2, 0.9, (N, O)),
        rng.uniform(0.05, 0.7, (N, O)),
        rng.uniform(0.05, 0.7, (N, O)),
    ], axis=-1).astype(np.float32)
    mask = (rng.rand(N, O) > 0.25).astype(np.float32)
    return vecs, boxes, mask


def _port(vecs, boxes, mask, H, W=None):
    out = tr.boxes_to_layout_batch(torch.from_numpy(vecs),
                                   torch.from_numpy(boxes), H, W,
                                   mask=torch.from_numpy(mask))
    return out.numpy()


def _pallas(vecs, boxes, mask, H):
    from ag2video_tpu.ops.pallas.rasterize_kernel import boxes_to_layout_pallas

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(boxes_to_layout_pallas(
            jnp.asarray(vecs), jnp.asarray(boxes), jnp.asarray(mask), H))


def _xla(vecs, boxes, mask, H, W=None):
    return np.asarray(jr.boxes_to_layout_batch(
        jnp.asarray(vecs), jnp.asarray(boxes), H, W,
        mask=jnp.asarray(mask), backend="xla"))


def test_plain_matches_pallas_and_xla(rng):
    vecs, boxes, mask = _inputs(rng, 3, 6, 128)
    out = _port(vecs, boxes, mask, 32)
    np.testing.assert_allclose(out, _pallas(vecs, boxes, mask, 32), **TOL)
    np.testing.assert_allclose(out, _xla(vecs, boxes, mask, 32), **TOL)


def test_plain_degenerate_and_masked(rng):
    vecs = rng.randn(1, 4, 128).astype(np.float32)
    boxes = rng.uniform(0.1, 0.5, (1, 4, 4)).astype(np.float32)
    boxes[0, 1, 2] = 0.0   # zero-width box
    boxes[0, 3, 3] = 0.0   # zero-height box
    mask = np.asarray([[1.0, 1.0, 0.0, 1.0]], np.float32)
    out = _port(vecs, boxes, mask, 16)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, _pallas(vecs, boxes, mask, 16), **TOL)
    np.testing.assert_allclose(out, _xla(vecs, boxes, mask, 16), **TOL)
    # Only object 0 contributes: 1 is zero-width, 2 masked, 3 zero-height.
    only0 = _port(vecs[:, :1], boxes[:, :1], mask[:, :1], 16)
    np.testing.assert_allclose(out, only0, **TOL)


@pytest.mark.parametrize("O,D,H,W", [(20, 24, 12, 20), (17, 5, 9, 1)])
def test_plain_many_objects_matches_xla(rng, O, D, H, W):
    """O > 16 (beyond the Pallas kernel's object pad), odd D, H != W."""
    vecs, boxes, mask = _inputs(rng, 2, O, D)
    np.testing.assert_allclose(_port(vecs, boxes, mask, H, W),
                               _xla(vecs, boxes, mask, H, W), **TOL)


def test_leading_dims_and_default_mask(rng):
    """(B, T, O, D) leading dims; mask=None drops all-zero boxes."""
    vecs, boxes, _ = _inputs(rng, 6, 5, 16)
    boxes[2, 4] = 0.0
    vecs, boxes = vecs.reshape(2, 3, 5, 16), boxes.reshape(2, 3, 5, 4)
    out = tr.boxes_to_layout_batch(torch.from_numpy(vecs),
                                   torch.from_numpy(boxes), 8).numpy()
    ref = np.asarray(jr.boxes_to_layout_batch(jnp.asarray(vecs),
                                              jnp.asarray(boxes), 8))
    assert out.shape == (2, 3, 8, 8, 16)
    np.testing.assert_allclose(out, ref, **TOL)


def test_one_sample_boxes_to_layout_matches_jax(rng):
    """The single-sample name: (O, D) vecs, (O, 4) boxes, no leading dims."""
    vecs, boxes, mask = _inputs(rng, 1, 5, 16)
    for m in (None, mask[0]):
        out = tr.boxes_to_layout(
            torch.from_numpy(vecs[0]), torch.from_numpy(boxes[0]), 8, 12,
            None if m is None else torch.from_numpy(m)).numpy()
        ref = np.asarray(jr.boxes_to_layout(
            jnp.asarray(vecs[0]), jnp.asarray(boxes[0]), 8, 12,
            None if m is None else jnp.asarray(m)))
        assert out.shape == (8, 12, 16)
        np.testing.assert_allclose(out, ref, **TOL)


def test_box_coverage_matches_jax(rng):
    _, boxes, mask = _inputs(rng, 2, 7, 1)
    boxes[1, 2, 2] = 0.0
    out = tr.box_coverage(torch.from_numpy(boxes), 10, 14,
                          torch.from_numpy(mask)).numpy()
    ref = np.asarray(jr.box_coverage(jnp.asarray(boxes), 10, 14,
                                     jnp.asarray(mask)))
    assert out.shape == (2, 7, 10, 14)
    np.testing.assert_allclose(out, ref, **TOL)


def test_plain_gradients_match_jax_vjp(rng):
    """The kernel's backward is autograd of the plain closed form; hold
    that against jax.vjp of the XLA path (the TPU kernel's `_bwd`)."""
    vecs, boxes, mask = _inputs(rng, 2, 5, 8)
    g = rng.randn(2, 12, 12, 8).astype(np.float32)

    v = torch.from_numpy(vecs).requires_grad_(True)
    b = torch.from_numpy(boxes).requires_grad_(True)
    out = tr.boxes_to_layout_plain(v, b, 12, 12, torch.from_numpy(mask))
    dv, db = torch.autograd.grad(out, (v, b), torch.from_numpy(g))

    def ref(vv, bb):
        return jr.boxes_to_layout_batch(vv, bb, 12, mask=jnp.asarray(mask),
                                        backend="xla")

    _, vjp = jax.vjp(ref, jnp.asarray(vecs), jnp.asarray(boxes))
    jdv, jdb = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb),
                               rtol=1e-4, atol=1e-4)


def test_bf16_output_dtype(rng):
    vecs, boxes, mask = _inputs(rng, 2, 3, 8)
    v = torch.from_numpy(vecs).to(torch.bfloat16)
    out = tr.boxes_to_layout_batch(v, torch.from_numpy(boxes), 8,
                                   mask=torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    # Same bf16 inputs on both sides: the outputs differ by at most one
    # bf16 rounding of the fp32 sum (2^-7 relative).
    ref = _xla(v.float().numpy(), boxes, mask, 8)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-2,
                               atol=1e-5)


def test_cpu_dispatch_counts_plain_and_never_launches(rng):
    vecs, boxes, mask = _inputs(rng, 1, 3, 8)
    tr.KERNEL_LAUNCHES.reset()
    tr.PLAIN_CALLS.reset()
    _port(vecs, boxes, mask, 8)
    assert (tr.KERNEL_LAUNCHES.n, tr.PLAIN_CALLS.n) == (0, 1)
    # The kernel's autograd.Function refuses CPU tensors instead of
    # falling back to the plain version.
    with pytest.raises(ValueError):
        tr.RasterizeFunction.apply(torch.from_numpy(vecs),
                                   torch.from_numpy(boxes),
                                   torch.from_numpy(mask), 8, 8)
    assert tr.KERNEL_LAUNCHES.n == 0


def test_dispatch_asks_the_one_rule(rng, monkeypatch):
    """With the CPU standing in for the kernels' device the dispatch hands
    the call to the kernel's autograd.Function, which refuses CPU tensors;
    inside `ops.plain()` it takes the plain version."""
    from ag2video_torch import ops
    from ag2video_torch.ops import _kernels

    vecs, boxes, mask = (torch.from_numpy(a) for a in _inputs(rng, 1, 3, 8))
    rule = _kernels.use_kernel  # the CPU stands in for the card
    monkeypatch.setattr(_kernels, "use_kernel", lambda dev, takes=True:
                        rule("cuda" if dev == "cpu" else dev, takes))
    tr.KERNEL_LAUNCHES.reset()
    tr.PLAIN_CALLS.reset()
    with pytest.raises(ValueError, match="CUDA"):
        tr.boxes_to_layout_batch(vecs, boxes, 8, mask=mask)
    with ops.plain():
        out = tr.boxes_to_layout_batch(vecs, boxes, 8, mask=mask)
    assert tr.PLAIN_CALLS.n == 1 and tr.KERNEL_LAUNCHES.n == 0
    assert torch.equal(out, tr.boxes_to_layout_plain(vecs, boxes, 8, 8,
                                                     mask))


# The card's bf16 kernel (csrc/rasterize.cu) splits the fp32 coverage into
# bf16 terms, contracts each with the bf16 vecs on the tensor cores (exact
# products, fp32 sums) and rounds once to bf16. Its tolerance against the
# plain version on the card is kernel_checks.BF16_TOL.
KERNEL_TERMS = 3


def _split_terms(cov, terms):
    """fp32 coverage -> `terms` bf16 tensors whose sum approximates it
    (hi, then the bf16 rounding of each remainder)."""
    out, rest = [], cov
    for _ in range(terms):
        h = rest.to(torch.bfloat16)
        out.append(h)
        rest = rest - h.float()
    return out, rest


def _rehearsal_inputs():
    """A reduced shape of the dense generator's: N=2, O=11, D=64, 64x64,
    bf16 vecs, boxes down to 0.05 wide, a masked object."""
    rng = np.random.RandomState(5)
    vecs, boxes, mask = _inputs(rng, 2, 11, 64)
    boxes[0, 3, 2:] = 0.05
    boxes[1, 7, 2] = 0.05
    mask[1, 2] = 0.0
    return (torch.from_numpy(vecs).to(torch.bfloat16),
            torch.from_numpy(boxes), torch.from_numpy(mask))


@pytest.mark.parametrize("terms,holds", [(1, False), (KERNEL_TERMS, True)])
def test_bf16_term_split_rehearsal(terms, holds):
    """The kernel's arithmetic on the CPU: one bf16 term (a plain bf16
    coverage) misses BF16_TOL; the kernel's three terms hold it."""
    vecs, boxes, mask = _rehearsal_inputs()
    ref = tr.boxes_to_layout_plain(vecs, boxes, 64, 64, mask).float()
    parts, _ = _split_terms(tr.box_coverage(boxes, 64, 64, mask), terms)
    acc = torch.zeros_like(ref)
    for p in parts:
        acc += torch.einsum("nohw,nod->nhwd", p.float(), vecs.float())
    got = acc.to(torch.bfloat16).float()
    bad = (got - ref).abs() > BF16_TOL["atol"] + BF16_TOL["rtol"] * ref.abs()
    assert bool(bad.any()) != holds, int(bad.sum())


def test_three_bf16_terms_are_exact():
    """hi + mid + lo gives back the fp32 coverage bit for bit, so the
    tensor-core products lose nothing."""
    _, boxes, mask = _rehearsal_inputs()
    cov = tr.box_coverage(boxes, 64, 64, mask)
    parts, rest = _split_terms(cov, KERNEL_TERMS)
    assert bool((rest == 0).all())
    total = parts[0].float() + parts[1].float() + parts[2].float()
    assert torch.equal(total, cov)
    _, rest2 = _split_terms(cov, 2)
    assert bool((rest2 != 0).any())
