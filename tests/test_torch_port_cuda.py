"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Marked `cuda`; they skip where no GPU is visible.

The card's machine has no JAX, and tests/conftest.py imports it, so run
them there without the conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_port_cuda.py
"""

import pytest
import torch


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conv3x3", "upsample2x_conv3x3",
                                  "flash_attention"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_kernel_matches_plain(kind, dtype):
    """On the card: the hand-written kernel against its plain version
    (tolerance as in chip_smoke.py: 2^-5 of the plain output's largest
    magnitude in bf16, 1e-4 of it in fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    key = {"conv3x3": ((2, 12, 10, 96), (3, 3, 96, 136)),
           "upsample2x_conv3x3": ((1, 5, 7, 64), (3, 3, 64, 72)),
           "flash_attention": ((2, 1100, 320), (2, 1100, 320), 8)}[kind]
    gen = torch.Generator(device="cuda").manual_seed(0)
    err, tol, *_ = chip_smoke.compare(kind, key, getattr(torch, dtype), gen)
    assert err <= tol
