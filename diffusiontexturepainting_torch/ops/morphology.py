"""Square-kernel binary dilation with a per-request radius.

Port of diffusiontexturepainting_tpu/ops/morphology.py. The kernel size
`pad` is a per-request value of the wire protocol, so the dilation is built
from prefix sums with clipped gather indices:

    dilate(m, ones(p, p))[y, x] = [ sum of m over the p x p window > 0 ]

Window convention: offsets [-(p-1)//2, p//2] on each axis (odd p is the
centered window; even p extends one extra to the bottom/right).
"""

from __future__ import annotations

import torch


def _window_any_1d(mask, pad, dim):
    """1.0 where any element within [i - (p-1)//2, i + p//2] along `dim`
    is nonzero."""
    n = mask.shape[dim]
    left = (pad - 1) // 2
    right = pad // 2
    csum = torch.cumsum((mask > 0).to(torch.int32), dim=dim)
    # a leading zero makes windowsum = S[hi] - S[lo-1] work at the border
    zero_shape = list(csum.shape)
    zero_shape[dim] = 1
    csum = torch.cat([csum.new_zeros(zero_shape), csum], dim=dim)
    idx = torch.arange(n, device=mask.device)
    hi = torch.clamp(idx + right, 0, n - 1) + 1
    lo = torch.clamp(idx - left, 0, n)
    wsum = csum.index_select(dim, hi) - csum.index_select(dim, lo)
    return (wsum > 0).to(mask.dtype)


def dilate_square(mask, pad):
    """Binary dilation of a (..., H, W, C) nonnegative mask by a pad x pad
    square; pad (int or 0-d tensor) <= 1 is a no-op. Returns a 0/1 mask of
    the same shape and dtype."""
    pad = torch.clamp(torch.as_tensor(pad, dtype=torch.int64,
                                      device=mask.device), min=1)
    out = _window_any_1d(mask, pad, dim=mask.dim() - 3)
    return _window_any_1d(out, pad, dim=mask.dim() - 2)


def add_extra_context(source_image, masked_image, mask, pad):
    """Texture-guidance context branch: paste the brush `source_image`
    everywhere outside the dilated painted mask.

    source_image, masked_image: (B, H, W, 3) in [-1, 1]; mask: (B, H, W, 1),
    1 = painted. Returns (context_masked_image, context_mask)."""
    hint_mask = 1.0 - dilate_square(mask, pad)
    context_masked_image = masked_image + source_image * hint_mask
    context_mask = torch.clamp(mask + hint_mask, 0.0, 1.0)
    return context_masked_image, context_mask
