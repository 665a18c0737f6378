"""How closely each CUDA kernel of the port must agree with its plain version
on the card, defined once: tests/test_torch_gpu.py holds each kernel to it
at its shapes, chip_smoke.py at the shapes it times (phase 2), and
tests/test_torch_rasterize.py's CPU emulation of the bf16 rasterizer."""

import torch

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: kernel and plain round fp32 sums taken in another order, so an
# output may differ by one bf16 rounding (at most 2^-7 relative).
BF16_TOL = dict(rtol=1e-2, atol=1e-5)

# The fused factorized frontend conv (csrc/objconv.cu) against its plain
# chain. Only the order of the fp32 sums differs (tensor cores against the
# fp32 bmm), which now and then flips one bf16 rounding of the conv's
# output before the norm: at most 0.1% of the elements may differ at all,
# and the whole by at most 1e-3 relative L2. In fp32 compute nothing is
# rounded to bf16 and every element may differ in its last bits: the whole
# by at most 1e-5 relative L2 (TF32 off in the plain chain's cuDNN conv).
OBJCONV_DIFFER = 1e-3
OBJCONV_REL_L2 = 1e-3
OBJCONV_REL_L2_FP32 = 1e-5


def same_bits(a, b):
    """Bit-equal, NaNs included; the message counts what differs. The
    fused SPADE denormalization (csrc/denorm.cu) is held to this."""
    assert a.dtype == b.dtype and a.shape == b.shape
    iview = torch.int16 if a.element_size() == 2 else torch.int32
    diff = a.view(iview) != b.view(iview)
    n = int(diff.sum())
    both_nan = int((diff & a.isnan() & b.isnan()).sum())
    assert n == 0, f"{n} elements differ ({both_nan} of them NaN in both)"


def differ(k, p):
    """(share of elements that differ, relative L2 of the difference)."""
    assert k.dtype == p.dtype and k.shape == p.shape
    ints = torch.int16 if k.dtype == torch.bfloat16 else torch.int32
    share = float((k.view(ints) != p.view(ints)).float().mean())
    rel = float((k.float() - p.float()).norm() / p.float().norm())
    return share, rel


def hold_objconv(k, p, what=""):
    """The objconv kernel's output `k` against the plain chain's `p`."""
    share, rel = differ(k, p)
    if k.dtype == torch.bfloat16:
        assert share <= OBJCONV_DIFFER and rel <= OBJCONV_REL_L2, \
            (what, share, rel)
    else:
        assert rel <= OBJCONV_REL_L2_FP32, (what, share, rel)
    return share, rel
