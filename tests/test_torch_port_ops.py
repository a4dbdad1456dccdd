"""The port's DDIM scheduler, morphology and resize ops against the JAX
package's, on the same seeded numpy inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.ops import morphology as t_morph
from diffusiontexturepainting_torch.ops import resize as t_resize
from diffusiontexturepainting_torch.schedulers.ddim import (
    DDIMScheduler as TorchDDIM)
from diffusiontexturepainting_tpu.ops import morphology as j_morph
from diffusiontexturepainting_tpu.ops import resize as j_resize
from diffusiontexturepainting_tpu.schedulers.ddim import (
    DDIMScheduler as JaxDDIM)

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [4, 20])
def test_ddim_tables_match(n):
    """Same float64 construction rounded to float32: exact."""
    ours = TorchDDIM().set_timesteps(n)
    ref = JaxDDIM().set_timesteps(n)
    np.testing.assert_array_equal(ours.timesteps, ref.timesteps)
    for key, val in ref.scan_rows().items():
        np.testing.assert_array_equal(ours.scan_rows()[key], val, err_msg=key)
    assert ours.num_iterations() == ref.num_iterations() == n
    assert ours.init_noise_sigma == ref.init_noise_sigma


@pytest.mark.parametrize("n", [4, 20])
def test_ddim_trajectory_matches(n):
    """A full eta = 0 trajectory with a fixed fake model output per step:
    float32 elementwise math on both sides, agreement to a few ulps."""
    rng = np.random.default_rng(n)
    x0 = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((n, 1, 4, 4, 4)).astype(np.float32)
    ours = TorchDDIM().set_timesteps(n)
    ref = JaxDDIM().set_timesteps(n)
    rows = ref.scan_rows()
    xt, xj = torch.from_numpy(x0), jnp.asarray(x0)
    for i, our_row in enumerate(ours.rows()):
        xt, _ = ours.step(torch.from_numpy(eps[i]), xt, our_row, {})
        row = {k: jnp.asarray(v[i]) for k, v in rows.items()}
        xj, _ = ref.step(jnp.asarray(eps[i]), xj, row)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pad", [0, 1, 2, 7, 30])
def test_dilate_square_matches(pad):
    """Binary result: exact."""
    rng = np.random.default_rng(pad)
    mask = (rng.random((2, 24, 20, 1)) > 0.93).astype(np.float32)
    want = np.asarray(j_morph.dilate_square(jnp.asarray(mask), pad))
    got = t_morph.dilate_square(torch.from_numpy(mask), torch.tensor(pad))
    np.testing.assert_array_equal(got.numpy(), want)


def test_add_extra_context_matches():
    """Sums and products of the same float32 values: exact."""
    rng = np.random.default_rng(1)
    src = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((1, 32, 32, 1), np.float32)
    mask[:, 4:12, 6:20] = 1.0
    masked = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32) * mask
    want = j_morph.add_extra_context(jnp.asarray(src), jnp.asarray(masked),
                                     jnp.asarray(mask), 5)
    got = t_morph.add_extra_context(torch.from_numpy(src),
                                    torch.from_numpy(masked),
                                    torch.from_numpy(mask), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nearest_downsample_matches():
    img = np.random.default_rng(2).random((3, 64, 48, 1)).astype(np.float32)
    want = np.asarray(j_resize.nearest_downsample(jnp.asarray(img), 8))
    got = t_resize.nearest_downsample(torch.from_numpy(img), 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,align,size_in,size_out", [
    ("bicubic", True, 64, 32),     # the brush preprocess, edges included
    ("bicubic", True, 40, 224),
    ("bilinear", False, 112, 224),  # the patch pyramid
])
def test_resize2d_matches(mode, align, size_in, size_out):
    """Same weight matrices, matmuls in another order: fp32 rounding."""
    img = np.random.default_rng(3).random(
        (2, size_in, size_in, 3)).astype(np.float32)
    want = np.asarray(j_resize.resize2d(jnp.asarray(img), size_out, size_out,
                                        mode=mode, align_corners=align))
    got = t_resize.resize2d(torch.from_numpy(img), size_out, size_out,
                            mode=mode, align_corners=align)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        t_resize._resize_matrix(size_in, size_out, mode, align),
        j_resize._resize_matrix(size_in, size_out, mode, align))
