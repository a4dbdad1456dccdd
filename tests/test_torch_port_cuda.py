"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Marked `cuda`; they skip where no GPU is visible.

The card's machine has no JAX, and tests/conftest.py imports it, so run
them there without the conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_port_cuda.py
"""

import pytest
import torch

# Small, ragged shapes: odd widths, channel counts off the tile sizes,
# several images per statistics chunk, no bias, no prologue.
CASES = {
    "conv3x3": ((2, 12, 10, 96), (3, 3, 96, 136)),
    "upsample2x_conv3x3": ((1, 5, 7, 64), (3, 3, 64, 72)),
    "flash_attention": ((2, 1100, 320), (2, 1100, 320), 8),
    "gn_conv_resident": ((3, 4, 4, 96), (3, 3, 96, 40), True, True, True,
                         True),
    "gn_conv_stream": ((2, 7, 9, 24), (3, 3, 24, 8), False, False, True,
                       False),
    "upconv_stream": ((2, 3, 5, 32), (3, 3, 32, 24), True),
    "ff_geglu": (37, 64, 256),
    "flash_attention_streaming": ((2, 1100, 320), (2, 1100, 320), 8),
    # views of one fused projection, hd off the 16-lane tiles
    "flash_attention_slotted": ((2, 384, 512), 4, 36),
    # odd sizes: the stride-2 conv drops the last row and column
    "downsample_conv3x3_stats": ((2, 7, 9, 24), (3, 3, 24, 136), True),
    # channels off the 16-byte groups: the kernel's scalar path
    "spatial_moments": ((2, 9, 7, 40),),
}


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_kernel_matches_plain(kind, dtype):
    """On the card: the hand-written kernel against its plain version
    (tolerance as in chip_smoke.py: 2^-5 of the plain output's largest
    magnitude in bf16, 1e-4 of it in fp32; the statistics against the
    same fraction of the sums of |y| and y^2)."""
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare(kind, CASES[kind], getattr(torch, dtype), gen)
    assert r["err_over_tol"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gn_conv_reads_a_weight_slice_in_place(dtype):
    """The split concat conv hands K1 w[:, :, lo:hi] of the full weight;
    the kernel reads the slice's taps stride(1) apart, with no copy."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import gn_conv

    dt = getattr(torch, dtype)
    B, H, W, ca, cs, cout = 2, 6, 5, 40, 56, 48
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x, w = rnd(B, H, W, cs).to(dt), (rnd(3, 3, ca + cs, cout) * 0.05).to(dt)
    a, c = rnd(B, cs) * 0.2 + 1, rnd(B, cs) * 0.2
    half = w[:, :, ca:]
    assert not half.is_contiguous()
    got, got_st = gn_conv.gn_conv_resident(x, a, c, half, None, None, True)
    want, want_st = gn_conv.gn_conv3x3_plain(x, a, c, half.contiguous(),
                                             None, None, True)
    rel = 2.0**-5 if dt == torch.bfloat16 else 1e-4
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= rel * peak
    scale = want.float().abs().sum((1, 2)).max().item()
    assert (got_st - want_st).abs()[:, 0].max().item() <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 4, 4, 1280), (2, 64, 64, 128)])
def test_spatial_moments_is_deterministic(shape):
    """K14 reduces in a fixed order: two calls give the same bits."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import groupnorm

    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    first = groupnorm.spatial_moments(x)
    assert torch.equal(first, groupnorm.spatial_moments(x))
