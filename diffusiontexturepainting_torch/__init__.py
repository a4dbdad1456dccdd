"""PyTorch + CUDA port of the diffusion texture painting system.

The JAX package `diffusiontexturepainting_tpu` is the reference; this
package computes the same stamps with PyTorch on an NVIDIA Hopper GPU,
through kernels written by hand in `csrc/`. It never imports JAX.
"""
