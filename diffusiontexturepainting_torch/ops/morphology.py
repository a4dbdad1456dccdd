"""Square-kernel binary dilation with a per-request radius.

Port of diffusiontexturepainting_tpu/ops/morphology.py. The kernel size
`pad` is a per-request value of the wire protocol, so the dilation is built
from prefix sums with clipped gather indices:

    dilate(m, ones(p, p))[y, x] = [ sum of m over the p x p window > 0 ]

Window convention: offsets [-(p-1)//2, p//2] on each axis (odd p is the
centered window; even p extends one extra to the bottom/right). A batch
may give each image its own pad (a list of B host integers): the same
prefix sums, the window bounds gathered per image.
"""

from __future__ import annotations

import torch


def _window_any_1d(mask, pad, dim):
    """1.0 where any element within [i - (p-1)//2, i + p//2] along `dim`
    is nonzero; pad an int, a 0-d tensor or a (B,) int64 tensor of one
    pad an image."""
    n = mask.shape[dim]
    left = (pad - 1) // 2
    right = pad // 2
    csum = torch.cumsum((mask > 0).to(torch.int32), dim=dim)
    # a leading zero makes windowsum = S[hi] - S[lo-1] work at the border
    zero_shape = list(csum.shape)
    zero_shape[dim] = 1
    csum = torch.cat([csum.new_zeros(zero_shape), csum], dim=dim)
    idx = torch.arange(n, device=mask.device)
    if isinstance(pad, torch.Tensor) and pad.dim() == 1:
        # per image: the bounds (B, n), gathered along `dim`
        left, right = left[:, None], right[:, None]
        view = [1] * mask.dim()
        view[0], view[dim] = -1, n
        size = list(csum.shape)
        size[dim] = n
        bound = lambda i: i.view(view).expand(size)
        hi = bound(torch.clamp(idx + right, 0, n - 1) + 1)
        lo = bound(torch.clamp(idx - left, 0, n))
        wsum = csum.gather(dim, hi) - csum.gather(dim, lo)
        return (wsum > 0).to(mask.dtype)
    hi = torch.clamp(idx + right, 0, n - 1) + 1
    lo = torch.clamp(idx - left, 0, n)
    wsum = csum.index_select(dim, hi) - csum.index_select(dim, lo)
    return (wsum > 0).to(mask.dtype)


def dilate_square(mask, pad):
    """Binary dilation of a (..., H, W, C) nonnegative mask by a pad x pad
    square; pad (int, 0-d tensor, or a list of one host int per image of a
    (B, H, W, C) mask) <= 1 is a no-op. Returns a 0/1 mask of the same
    shape and dtype."""
    if isinstance(pad, (list, tuple)):
        if len(pad) != mask.shape[0]:
            raise ValueError(f"{len(pad)} pads for a batch of "
                             f"{mask.shape[0]}")
        pad = torch.tensor([max(1, int(p)) for p in pad],
                           dtype=torch.int64).to(mask.device)
    elif isinstance(pad, torch.Tensor):
        pad = torch.clamp(pad.to(device=mask.device, dtype=torch.int64),
                          min=1)
    else:
        # a host integer stays on the host: copying it to the device would
        # make the caller wait for the stream (a stroke session's stamps
        # are enqueued without waiting)
        pad = max(1, int(pad))
    out = _window_any_1d(mask, pad, dim=mask.dim() - 3)
    return _window_any_1d(out, pad, dim=mask.dim() - 2)


def add_extra_context(source_image, masked_image, mask, pad):
    """Texture-guidance context branch: paste the brush `source_image`
    everywhere outside the dilated painted mask.

    source_image, masked_image: (B, H, W, 3) in [-1, 1]; mask: (B, H, W, 1),
    1 = painted; pad as dilate_square takes it. Returns
    (context_masked_image, context_mask)."""
    hint_mask = 1.0 - dilate_square(mask, pad)
    context_masked_image = masked_image + source_image * hint_mask
    context_mask = torch.clamp(mask + hint_mask, 0.0, 1.0)
    return context_masked_image, context_mask
