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
    # the staged-tile mode (csrc/conv_staged.cu)
    "conv3x3_inpad": ((2, 12, 10, 96), (3, 3, 96, 136)),
    "upsample2x_conv3x3_inpad": ((1, 5, 7, 64), (3, 3, 64, 72)),
    "conv3x3_stream": ((1, 17, 9, 48), (3, 3, 48, 130)),
    "gn_silu_conv3x3": ((2, 9, 10, 64), (3, 3, 64, 136), True, True, 32),
}
STAGED = ("conv3x3_inpad", "upsample2x_conv3x3_inpad", "conv3x3_stream",
          "gn_silu_conv3x3")


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


# Odd H and W, Cin 3, 9 and 48 (ragged channel chunks), a 1x1 image, Cout
# off the 128- and 64-column tiles.
RAGGED = [((1, 7, 5, 3), (3, 3, 3, 40)), ((2, 3, 9, 9), (3, 3, 9, 24)),
          ((1, 1, 1, 48), (3, 3, 48, 130)), ((2, 11, 19, 48), (3, 3, 48, 8))]


def _staged_key(kind, key):
    return key + (True, True, 3) if kind == "gn_silu_conv3x3" else key


@pytest.mark.cuda
@pytest.mark.parametrize("key", RAGGED, ids=str)
@pytest.mark.parametrize("kind", STAGED)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_staged_kernels_at_ragged_shapes(kind, key, dtype):
    """The staged-tile kernels against their plain versions where the
    window, the channel chunks and the Cout tile are ragged (K10 with 3
    groups of Cin / 3 channels, temb and residual)."""
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare(kind, _staged_key(kind, key),
                           getattr(torch, dtype), gen)
    assert r["err_over_tol"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STAGED)
def test_staged_kernels_are_deterministic(kind):
    """No split-K and no atomics: two calls give the same bits."""
    gen = _setup()
    import chip_smoke

    kernel = chip_smoke.kernel_case(kind, CASES[kind], torch.bfloat16,
                                    gen)[0]
    first = kernel()
    assert torch.equal(first, kernel())


@pytest.mark.cuda
def test_in_pad_moves_launches_to_the_staged_kernels():
    """With the port's _IN_PAD set, conv3x3 and upsample2x_conv3x3 launch
    K12a/b and not K7/K4; the switch restored, K7/K4 again."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import conv3x3

    x = torch.randn((2, 8, 8, 32), generator=gen, device="cuda").bfloat16()
    w = torch.randn((3, 3, 32, 64), generator=gen,
                    device="cuda").bfloat16() * 0.05
    b = torch.zeros(64, dtype=torch.bfloat16, device="cuda")
    taps = conv3x3.fold_upsample_weights(w)
    counters = (conv3x3.conv3x3_launches, conv3x3.upsample_launches,
                conv3x3.conv3x3_inpad_launches,
                conv3x3.upsample_inpad_launches)
    seen = []
    for on in (True, False):
        for c in counters:
            c.reset()
        conv3x3._IN_PAD = on
        try:
            conv3x3.conv3x3(x, w, b)
            conv3x3.upsample2x_conv3x3(x, w, b, taps)
        finally:
            conv3x3._IN_PAD = False
        seen.append([c.launches for c in counters])
    assert seen == [[0, 0, 1, 1], [1, 1, 0, 0]]


@pytest.mark.cuda
def test_staged_entries_raise_and_never_fall_back():
    """A CUDA tensor of a type, shape or layout the kernel does not take
    raises; it never runs the plain version."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import conv3x3

    x = torch.randn((1, 8, 8, 32), generator=gen, device="cuda")
    w = torch.randn((3, 3, 32, 64), generator=gen, device="cuda")
    b = torch.zeros(64, device="cuda")
    s = torch.ones(32, device="cuda")
    with pytest.raises(TypeError):
        conv3x3.conv3x3_inpad(x.half(), w.half(), b.half())
    with pytest.raises(ValueError):
        conv3x3.conv3x3_stream(x, w[:, :, :16], b)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_inpad(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        conv3x3.upsample2x_conv3x3_inpad(x, w, b, w)
    with pytest.raises(ValueError):
        conv3x3.gn_silu_conv3x3(x, s, s, w, b, num_groups=5)
    with pytest.raises(ValueError):
        conv3x3.gn_silu_conv3x3(x, s, s, w, b, temb=torch.zeros(
            (2, 64), device="cuda"))
    with pytest.raises(TypeError):
        conv3x3.gn_silu_conv3x3(x, s.bfloat16(), s, w, b)


# The softmax arms (csrc/attn_arms.cu), the head-layout arms
# (csrc/attn_layouts.cu) and T1 (csrc/attn_transposed.cu): head dims 40, 80
# and 160 (the kernel's three
# register tiles), a ragged length, each option. T3's chunk must divide Lk,
# so its keys are 1152 against 1100 queries.
ARM_KEYS = {
    "nomax_attention": [(True, False), (False, False), (False, True)],
    "chunked_attention": [(64, False), (128, False), (64, True)],
    "nomax_unpadded": [()],
    "pvt_attention": [()],
    "nomax_4d": [()],
    "nomax_allheads": [()],
    "nomax_laneslice": [()],
    "sublane_attention": [()],
}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 160])
@pytest.mark.parametrize("kind", list(ARM_KEYS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_arms_match_plain(kind, hd, dtype):
    """Each arm and option against its plain version at L 1100, 2 images
    of 4 heads (tolerance as chip_smoke.py's)."""
    gen = _setup()
    import chip_smoke

    lk = 1152 if kind == "chunked_attention" else 1100
    for options in ARM_KEYS[kind]:
        key = ((2, 1100, 4 * hd), (2, lk, 4 * hd), 4) + options
        r = chip_smoke.compare(kind, key, getattr(torch, dtype), gen)
        assert r["err_over_tol"] <= 1.0, (key, r)


@pytest.mark.cuda
def test_attention_arms_raise_and_never_fall_back():
    """hd > 160, T3's bk outside {64, 128} or not dividing Lk, fp16 and
    non-contiguous inputs raise; a CUDA call launches the kernel (its
    count moves) and returns a CUDA tensor."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import attention_variants as av

    x = torch.randn((1, 256, 2 * 168), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="160"):
        av.nomax_unpadded(x, x, x, 2)
    y = torch.randn((1, 256, 80), generator=gen, device="cuda")
    with pytest.raises(ValueError):
        av.chunked_attention(y, y, y, 2, bk=32)
    with pytest.raises(ValueError):
        av.chunked_attention(y, y, y, 2, bk=96)
    with pytest.raises(TypeError):
        av.pvt_attention(y.half(), y.half(), y.half(), 2)
    z = y[:, ::2]  # rows two apart: not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        av.nomax_attention(z, z, z, 2)
    for name, (wrapper, _) in av.ARMS.items():
        counter = av.LAUNCHES[name]
        before = counter.launches
        # T4's fourth argument is its scale; y is then (BH 1, L, P 80)
        out = wrapper(y, y, y, 40**-0.5 if name == "slotted_kernel_call"
                      else 2)
        torch.cuda.synchronize()
        assert out.is_cuda and counter.launches == before + 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("exp2_bf16", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_slotted_kernel_matches_plain(exp2_bf16, dtype):
    """T4 over 128-lane slots (hd 40, zero pad lanes) at L 1100 (a ragged
    last tile), 2 images of 4 heads, against its plain version (tolerance
    as chip_smoke.py's; the pad lanes of the output zero)."""
    gen = _setup()
    import chip_smoke

    key = ((8, 1100, 128), (8, 1100, 128), 4, 40, exp2_bf16)
    r = chip_smoke.compare("slotted_kernel_call", key, getattr(torch, dtype),
                           gen)
    assert r["err_over_tol"] <= 1.0, r


@pytest.mark.cuda
def test_slotted_kernel_raises_and_never_falls_back():
    """More than 160 lanes, fp16 and non-contiguous inputs raise."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import attention_variants as av

    wide = torch.randn((2, 256, 168), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="160"):
        av.slotted_kernel_call(wide, wide, wide, 40**-0.5)
    x = torch.randn((2, 256, 128), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        av.slotted_kernel_call(x.half(), x.half(), x.half(), 40**-0.5)
    z = x[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        av.slotted_kernel_call(z, z, z, 40**-0.5)
    # K13's bf16 entry (csrc/flash_attention_sm90.cu): a row stride off
    # 16 bytes and fp16 raise before any launch
    from diffusiontexturepainting_torch.ops import attention

    qkv = torch.randn((2, 256, 3 * 512 + 4), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = (qkv[..., i * 512:(i + 1) * 512] for i in range(3))
    before = attention.flash_slotted_launches.launches
    with pytest.raises(ValueError, match="TMA"):
        attention.flash_attention_slotted(q, k, v, 4, 40)
    with pytest.raises(TypeError):
        attention.flash_attention_slotted(q.half(), k.half(), v.half(), 4, 40)
    assert attention.flash_slotted_launches.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 160])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layout_arms_equal_t5_bit_for_bit(hd, dtype):
    """T5 (heads split by a copy pass, one head a launch) and T6, T7, T8
    (heads read in place, three block mappings) run the same tile code on
    the same values: the same bits at L 1100, 2 images of 4 heads."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import attention_variants as av

    q, k, v = (torch.randn((2, 1100, 4 * hd), generator=gen,
                           device="cuda").to(getattr(torch, dtype))
               for _ in range(3))
    t5 = av.nomax_unpadded(q, k, v, 4)
    for wrapper in (av.nomax_4d, av.nomax_allheads, av.nomax_laneslice):
        assert torch.equal(wrapper(q, k, v, 4), t5), wrapper.__name__


# T10 (bf16: csrc/pv_product_sm90.cu, fp32: csrc/attn_transposed.cu): hd on
# and off the wgmma N buckets and m64 tiles, bq off the 64-row tile, Lk off
# every key chunk, 3 bh. bf16 needs Lk and hd multiples of 8 (TMA's 16-byte
# rows): it runs Lk 1000 for 1100 and hd 152 for 150, and refuses those.
@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 150, 160])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pv_product_matches_plain(hd, transposed, dtype):
    """Both orientations against the plain version at (bh 3, bq 100, Lk
    1100 (bf16: 1000) and 1096), 1 and 3 passes (tolerance as
    chip_smoke.py's)."""
    gen = _setup()
    import chip_smoke
    from diffusiontexturepainting_torch.ops import attention_variants

    ragged = 1100
    if dtype == "bfloat16":
        for lk, h in ((ragged, 40), (1096, hd)):
            if lk % 8 or h % 8:
                e = torch.rand((3, 100, lk), device="cuda").bfloat16()
                v = torch.rand((3, lk, h), device="cuda").bfloat16()
                with pytest.raises(ValueError, match="TMA"):
                    attention_variants.pv_product(e, v)
        ragged, hd = 1000, hd + (-hd) % 8
    for lk, iters in ((ragged, 3), (1096, 1)):
        key = ((3, 100, lk), (3, lk, hd), transposed, iters)
        r = chip_smoke.compare("pv_product", key, getattr(torch, dtype), gen)
        assert r["err_over_tol"] <= 1.0, (key, r)


@pytest.mark.cuda
def test_pv_product_orientations_agree_and_passes_add():
    """e v and (v^T e^T)^T sum the same products in another order; `iters`
    passes give `iters` times one pass, up to the output's rounding."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import attention_variants as av

    e = torch.rand((2, 200, 1024), generator=gen, device="cuda").bfloat16()
    v = torch.rand((2, 1024, 80), generator=gen, device="cuda").bfloat16()
    one = av.pv_product(e, v).float()
    flipped = av.pv_product(e, v, transposed=True).float()
    assert (one - flipped).abs().max() <= 2.0**-7 * one.abs().max()
    five = av.pv_product(e, v, iters=5).float()
    assert (five - 5 * one).abs().max() <= 2.0**-6 * five.abs().max()


@pytest.mark.cuda
def test_transposed_arms_raise_and_never_fall_back():
    """hd > 160, fp16, non-contiguous and mismatched operands raise; a CUDA
    call launches the kernel (its count moves)."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import attention_variants as av

    e = torch.rand((1, 64, 128), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="160"):
        av.pv_product(e, torch.rand((1, 128, 168), device="cuda"))
    with pytest.raises(TypeError):
        av.pv_product(e.half(), torch.rand((1, 128, 40),
                                           device="cuda").half())
    with pytest.raises(ValueError, match="contiguous"):
        av.pv_product(e, torch.rand((1, 40, 128),
                                    device="cuda").transpose(1, 2))
    with pytest.raises(ValueError):
        av.pv_product(e, torch.rand((1, 120, 40), device="cuda"))
    before = av.pv_product_launches.launches
    out = av.pv_product(e, torch.rand((1, 128, 40), device="cuda"), iters=2)
    torch.cuda.synchronize()
    assert out.is_cuda and av.pv_product_launches.launches == before + 1


# The conv arms (csrc/conv_arms.cu): T12 at RAGGED's shapes with and without
# a bias; T11's four reads over 2 windows at TAPS_RAGGED's shapes, without
# and with the loop carry.
@pytest.mark.cuda
@pytest.mark.parametrize("key", RAGGED, ids=str)
@pytest.mark.parametrize("has_bias", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pipelined_matches_plain(key, has_bias, dtype):
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare("pipelined", key + (has_bias,),
                           getattr(torch, dtype), gen)
    assert r["err_over_tol"] <= 1.0, r


# (H_T, W, Cin, N): odd rows and widths, Cin 3, 9 and 48, N off the tiles
# (no 1x1 window: `unshifted` reads only its zero pad pixel there)
TAPS_RAGGED = [(7, 5, 3, 40), (3, 9, 9, 24), (2, 3, 48, 130),
               (11, 19, 48, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TAPS_RAGGED, ids=str)
@pytest.mark.parametrize("read", ["shifted", "unshifted", "rowflat",
                                  "jointw"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_window_taps_match_plain(shape, read, dtype):
    gen = _setup()
    import chip_smoke

    h_t, W, cin, n = shape
    for reps in (1, 3):
        taps = chip_smoke.taps_key(2, h_t, W, cin, n, read, reps)
        r = chip_smoke.compare("conv_window_taps", taps,
                               getattr(torch, dtype), gen)
        assert r["err_over_tol"] <= 1.0, (taps, r)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pipelined", "conv_window_taps"])
def test_conv_arms_are_deterministic(kind):
    """No split-K and no atomics; T11's carry is a fixed-order block
    reduction: two calls give the same bits."""
    gen = _setup()
    import chip_smoke

    key = (((2, 12, 10, 96), (3, 3, 96, 136), True) if kind == "pipelined"
           else chip_smoke.taps_key(3, 8, 40, 96, 136, "jointw", 3))
    kernel = chip_smoke.kernel_case(kind, key, torch.bfloat16, gen)[0]
    first = kernel()
    assert torch.equal(first, kernel())


@pytest.mark.cuda
def test_pipelined_border_is_silu_of_c_on_the_card():
    """x = 0, a = 0: every conv input, the pad ring included, is silu(c),
    so every output is the full 9-tap sum, corners included."""
    _setup()
    from diffusiontexturepainting_torch.ops import conv_variants as cv

    cin, cout = 40, 24
    x = torch.zeros((2, 9, 21, cin), device="cuda")
    a = torch.zeros((2, cin), device="cuda")
    c = torch.linspace(-2, 2, cin, device="cuda").repeat(2, 1)
    w = torch.ones((3, 3, cin, cout), device="cuda")
    got = cv.pipelined(x, a, c, w, None)
    full = 9 * torch.nn.functional.silu(c[0]).sum().item()
    assert torch.allclose(got, torch.full_like(got, full), rtol=1e-5)


@pytest.mark.cuda
def test_conv_arms_raise_and_never_fall_back():
    """A CUDA tensor of a type, shape or layout the kernels do not take
    raises; a CUDA call launches the kernel (its count moves)."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import conv_variants as cv

    x = torch.randn((1, 8, 8, 32), generator=gen, device="cuda")
    w = torch.randn((3, 3, 32, 64), generator=gen, device="cuda")
    a = torch.ones((1, 32), device="cuda")
    with pytest.raises(TypeError):
        cv.pipelined(x.half(), a, a, w.half(), None)
    with pytest.raises(ValueError):
        cv.pipelined(x, a[:, :16], a, w, None)
    with pytest.raises(ValueError):
        cv.pipelined(x.transpose(1, 2), a, a, w, None)
    xw = torch.randn((2, 10, 16, 32), generator=gen, device="cuda")
    w9 = w.view(9, 32, 64)
    with pytest.raises(TypeError):
        cv.conv_window_taps(xw.bfloat16(), w9, "shifted", W=14)
    with pytest.raises(ValueError):
        cv.conv_window_taps(xw, w9, "jointw", W=14)
    with pytest.raises(ValueError, match="contiguous"):
        cv.conv_window_taps(xw[:, :, ::2], w9, "shifted", W=6)
    for counter, call in (
            (cv.pipelined_launches, lambda: cv.pipelined(x, a, a, w, None)),
            (cv.conv_window_taps_launches,
             lambda: cv.conv_window_taps(xw, w9, "rowflat", W=14, reps=2))):
        before = counter.launches
        out = call()
        torch.cuda.synchronize()
        assert out.is_cuda and counter.launches == before + 1


# The bf16 K8 and K13 (csrc/flash_attention_sm90.cu: wgmma fed by TMA) at
# every head-dim bucket (hd 8 and 40 in the 48 bucket, 64 and 80 in 80,
# 128, 160 in 256, 512 in two 256-column slices) and at ragged lengths:
# one key, a tile's tail, a tile and one, several tiles and a tail.
SM90_HDS = (8, 40, 64, 80, 128, 160, 512)
SM90_LENGTHS = (1, 63, 129, 1100)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", SM90_HDS)
@pytest.mark.parametrize("length", SM90_LENGTHS)
def test_sm90_streaming_matches_plain(hd, length):
    """K8 in bf16 against plain_attention_streaming (chip_smoke's tolerance:
    2^-5 of the plain output's largest magnitude)."""
    gen = _setup()
    import chip_smoke

    heads = 1 if hd == 512 else 2
    key = ((2, length, heads * hd), (2, length, heads * hd), heads)
    r = chip_smoke.compare("flash_attention_streaming", key, torch.bfloat16,
                           gen)
    assert r["err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(129, 1100), (1100, 63), (2, 300)])
def test_sm90_streaming_takes_any_lq_and_lk(lq, lk):
    gen = _setup()
    import chip_smoke

    key = ((2, lq, 320), (2, lk, 320), 8)
    r = chip_smoke.compare("flash_attention_streaming", key, torch.bfloat16,
                           gen)
    assert r["err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("hd", (8, 36, 40, 64, 80, 128))
@pytest.mark.parametrize("length", SM90_LENGTHS)
def test_sm90_slotted_matches_plain(hd, length):
    """K13 in bf16 on views of one fused projection (zero pad lanes), the
    output's pad lanes checked zero by compare."""
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare("flash_attention_slotted",
                           ((2, length, 4 * 128), 4, hd), torch.bfloat16, gen)
    assert r["err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("hd", (36, 40, 80))
def test_sm90_slotted_reads_only_the_real_lanes(hd):
    """Pad lanes of q, k and v hold NaN: the kernel reads only the hd real
    lanes (TMA describes them alone), so its output is finite, equal to
    the plain version's within tolerance, and its pad lanes are zero."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import attention

    B, L, H = 2, 700, 4
    qkv = torch.full((B, L, 3, H, 128), float("nan"), dtype=torch.bfloat16,
                     device="cuda")
    qkv[..., :hd] = torch.randn((B, L, 3, H, hd), generator=gen,
                                device="cuda").bfloat16()
    q, k, v = qkv.view(B, L, 3 * H * 128).chunk(3, dim=-1)
    got = attention.flash_attention_slotted(q, k, v, H, hd)
    want = attention.plain_attention_slotted(q, k, v, H, hd)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert not got.view(B, L, H, 128)[..., hd:].any()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0**-5 * want.float().abs().max().item()


@pytest.mark.cuda
def test_sm90_replays_bit_identically():
    """The same inputs give the same bits (no atomics, a fixed order)."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import attention

    q, k, v = (torch.randn((2, 1100, 320), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    a = attention.flash_attention_streaming(q, k, v, 8)
    b = attention.flash_attention_streaming(q, k, v, 8)
    w = torch.randn((1, 1100, 512), generator=gen, device="cuda").bfloat16()
    c = attention.flash_attention_streaming(w, w, w, 1)
    d = attention.flash_attention_streaming(w, w, w, 1)
    qkv = torch.randn((2, 1100, 3 * 1024), generator=gen,
                      device="cuda").bfloat16()
    sq, sk, sv = qkv.chunk(3, dim=-1)
    e = attention.flash_attention_slotted(sq, sk, sv, 8, 40)
    f = attention.flash_attention_slotted(sq, sk, sv, 8, 40)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d) and torch.equal(e, f)


@pytest.mark.cuda
def test_sm90_refuses_what_tma_cannot_describe():
    """bf16 K8 and K2 at hd 36 (a 72-byte head stride), K8 on a base 2
    bytes off 16, and K13 on a row stride off 16 bytes, raise ValueError
    and launch nothing; fp32 K8 at hd 36 still runs the FMA twin."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import attention

    x = torch.randn((2, 300, 4 * 36), generator=gen, device="cuda")
    flat = torch.randn(1 + 2 * 300 * 320, generator=gen,
                       device="cuda").bfloat16()
    off = flat[1:].view(2, 300, 320)
    qkv = torch.randn((2, 300, 3 * 1024 + 8 + 4), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = (qkv[..., i * 1024:(i + 1) * 1024] for i in range(3))
    counters = (attention.flash_streaming_launches,
                attention.flash_slotted_launches, attention.flash_launches)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="TMA"):
        attention.flash_attention_streaming(x.bfloat16(), x.bfloat16(),
                                            x.bfloat16(), 4)
    with pytest.raises(ValueError, match="TMA"):
        attention.flash_attention(x.bfloat16(), x.bfloat16(), x.bfloat16(),
                                  4)
    with pytest.raises(ValueError, match="TMA"):
        attention.flash_attention_streaming(off, off, off, 8)
    with pytest.raises(ValueError, match="TMA"):
        attention.flash_attention_slotted(q, k, v, 8, 40)
    assert [c.launches for c in counters] == before
    out = attention.flash_attention_streaming(x, x, x, 4)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.cuda
def test_sm90_dtype_dispatch_and_launch_counters(monkeypatch):
    """A bf16 call reaches the sm90 entry, an fp32 call the FMA twin's, and
    each moves its wrapper's counter by one."""
    gen = _setup()
    from diffusiontexturepainting_torch import _cuda
    from diffusiontexturepainting_torch.ops import attention

    asked = []
    real = _cuda.function

    def spy(source, symbol, argtypes):
        asked.append((source, symbol))
        return real(source, symbol, argtypes)

    monkeypatch.setattr(_cuda, "function", spy)
    x = torch.randn((1, 300, 320), generator=gen, device="cuda")
    qkv = torch.randn((1, 300, 3 * 1024), generator=gen, device="cuda")
    for dt, source, suffix in ((torch.bfloat16, "flash_attention_sm90",
                                "_sm90"),
                               (torch.float32, "flash_attention", "")):
        asked.clear()
        before = (attention.flash_streaming_launches.launches,
                  attention.flash_slotted_launches.launches,
                  attention.flash_launches.launches)
        attention.flash_attention_streaming(x.to(dt), x.to(dt), x.to(dt), 8)
        sq, sk, sv = qkv.to(dt).chunk(3, dim=-1)
        attention.flash_attention_slotted(sq, sk, sv, 8, 40)
        attention.flash_attention(x.to(dt), x.to(dt), x.to(dt), 8)
        torch.cuda.synchronize()
        assert asked == [
            (source, "dtp_flash_attention_streaming" + suffix),
            (source, "dtp_flash_attention_slotted" + suffix),
            (source, "dtp_flash_attention" + suffix)]
        assert (attention.flash_streaming_launches.launches,
                attention.flash_slotted_launches.launches,
                attention.flash_launches.launches) == (
                    before[0] + 1, before[1] + 1, before[2] + 1)


@pytest.mark.cuda
def test_sm90_plan_matches_the_library():
    """ops/attention.py sm90_plan equals the built library's plan for every
    hd in 1..512, at long and short grids."""
    _setup()
    import ctypes

    from diffusiontexturepainting_torch import _cuda
    from diffusiontexturepainting_torch.ops import attention

    fn = _cuda.library("flash_attention_sm90").dtp_flash_attention_sm90_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_int * 7)()
    for lq, bh in ((16384, 24), (1024, 24), (1024, 2), (4096, 3), (1, 1)):
        for hd in range(1, 513):
            assert fn(hd, lq, bh, out) == 0
            p = attention.sm90_plan(hd, lq, bh)
            assert list(out) == [p["bucket"], p["kd"], p["nv"], p["bkv"],
                                 p["consumers"], p["slices"], p["smem"]]


# bf16 K2 (the same body as K8, its grid-fill plan and the hd-160 bucket)
# at every head-dim bucket and ragged lengths.
K2_HDS = (8, 40, 64, 80, 128, 160, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", K2_HDS)
@pytest.mark.parametrize("length", SM90_LENGTHS)
def test_sm90_resident_matches_plain(hd, length):
    """K2 in bf16 against its plain version, K8's (chip_smoke's
    tolerance)."""
    gen = _setup()
    import chip_smoke

    heads = 1 if hd == 512 else 2
    key = ((2, length, heads * hd), (2, length, heads * hd), heads)
    r = chip_smoke.compare("flash_attention", key, torch.bfloat16, gen)
    assert r["err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("hd", (40, 160, 512))
def test_sm90_every_bucket_computes_k2(hd):
    """Every bucket at least hd deep gives K2's function (the probes'
    overrides), and the bucket the plan picks equals the default call."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import attention

    heads = 1 if hd == 512 else 4
    q, k, v = (torch.randn((2, 1100, heads * hd), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    want = attention.plain_attention_streaming(q, k, v, heads)
    tol = 2.0**-5 * want.float().abs().max().item()
    plan = attention.sm90_plan(hd, 1100, 2 * heads)["bucket"]
    default = attention.flash_attention(q, k, v, heads)
    for i, (kd, *_) in enumerate(attention.SM90_BUCKETS):
        if kd < hd:
            continue
        got = attention.flash_attention(q, k, v, heads, bucket=i)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (i, err, tol)
        if i == plan:
            assert torch.equal(got, default)


# bf16 K9 (csrc/conv_sm90.cu) at the default stamp's three shapes and at
# ragged ones: odd H and W, Cin and Cout off 64 and 128, one output pixel
K9_KEYS = [((2, 256, 256, 128), (3, 3, 128, 128), True),
           ((2, 128, 128, 256), (3, 3, 256, 256), True),
           ((2, 64, 64, 512), (3, 3, 512, 512), True),
           ((1, 18, 34, 48), (3, 3, 48, 40), True),
           ((2, 7, 9, 24), (3, 3, 24, 136), True),
           ((2, 2, 2, 16), (3, 3, 16, 8), True),
           ((1, 33, 31, 200), (3, 3, 200, 264), True),
           ((1, 32, 32, 256), (3, 3, 256, 256), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("key", K9_KEYS, ids=str)
def test_sm90_downconv_matches_plain(key):
    """bf16 K9 against its plain version, output and statistics
    (chip_smoke's tolerance)."""
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare("downsample_conv3x3_stats", key, torch.bfloat16,
                           gen)
    assert r["err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("consumers", [1, 2])
def test_sm90_downconv_tiles_agree_and_replay(consumers):
    """Both tiles (one or two consumer warpgroups) compute the same output
    bits; each call's output and statistics are bit-identical on replay."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import gn_conv

    x = torch.randn((2, 64, 66, 128), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((3, 3, 128, 256), generator=gen, device="cuda")
         * 0.03).bfloat16()
    b = torch.randn(256, generator=gen, device="cuda").bfloat16()
    a1, s1 = gn_conv.downconv_stream(x, w, b, consumers=consumers)
    a2, s2 = gn_conv.downconv_stream(x, w, b, consumers=consumers)
    other, _ = gn_conv.downconv_stream(x, w, b, consumers=3 - consumers)
    torch.cuda.synchronize()
    assert torch.equal(a1, a2) and torch.equal(s1, s2)
    assert torch.equal(a1, other)


@pytest.mark.cuda
def test_sm90_downconv_refuses_what_tma_cannot_describe():
    """bf16 K9 at Cin 20, Cout 12, or on a base 2 bytes off 16 raises
    ValueError and launches nothing; fp32 at Cin 20 runs the FMA twin."""
    gen = _setup()
    from diffusiontexturepainting_torch.ops import gn_conv

    x = torch.randn((1, 16, 16, 20), generator=gen, device="cuda")
    w = torch.randn((3, 3, 20, 16), generator=gen, device="cuda")
    w12 = torch.randn((3, 3, 16, 12), generator=gen, device="cuda").bfloat16()
    flat = torch.randn(1 + 16 * 16 * 16, generator=gen,
                       device="cuda").bfloat16()
    off = flat[1:].view(1, 16, 16, 16)
    w16 = torch.randn((3, 3, 16, 16), generator=gen, device="cuda").bfloat16()
    before = gn_conv.downconv_stream_launches.launches
    for call in (lambda: gn_conv.downconv_stream(x.bfloat16(), w.bfloat16(),
                                                 None),
                 lambda: gn_conv.downconv_stream(off.contiguous(), w12,
                                                 None),
                 lambda: gn_conv.downconv_stream(off, w16, None)):
        with pytest.raises(ValueError, match="TMA"):
            call()
    assert gn_conv.downconv_stream_launches.launches == before
    out, stats = gn_conv.downconv_stream(x, w, None)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(stats).all()


@pytest.mark.cuda
def test_sm90_downconv_plan_matches_the_library():
    """ops/gn_conv.py downconv_sm90_plan equals the built library's plan at
    the paths' shapes and ragged ones, forced tiles included."""
    _setup()
    import ctypes

    from diffusiontexturepainting_torch import _cuda
    from diffusiontexturepainting_torch.ops import gn_conv

    fn = _cuda.library("conv_sm90").dtp_downsample_conv3x3_sm90_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    out = (ctypes.c_int * 8)()
    shapes = [(2, 2 * h, 2 * h, c, c) for h in (512, 256, 128, 64, 32)
              for c in (128, 256, 512)]
    shapes += [(1, 18, 34, 48, 40), (2, 7, 9, 24, 136), (2, 2, 2, 16, 8)]
    for B, H, W, cin, cout in shapes:
        for nc in (0, 1, 2):
            assert fn(B, H, W, cin, cout, nc, out) == 0
            p = gn_conv.downconv_sm90_plan(B, H, W, cin, cout, nc or None)
            assert list(out) == [p["consumers"], p["rows"], p["stages"],
                                 p["smem"], p["tiles_h"], p["tiles_w"],
                                 p["m_tiles"], p["n_tiles"]]
