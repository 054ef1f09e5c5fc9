"""phaser_tpu_torch — the PyTorch / CUDA port of phaser_tpu.

Runs phaser_tpu's `phaser` engine with allele assignment on an NVIDIA
Hopper GPU (H100): the Pallas TPU classifier becomes hand-written CUDA
kernels (csrc/alleles.cu), built with nvcc at first use.  The JAX-free
modules of phaser_tpu (io, host engine stages, writers, host mapper) are
imported, not copied; this package never imports jax.

Entry point: `python -m phaser_tpu_torch.cli.phaser_main` (the flags of
`phaser`, with --device cuda|cpu|host).
"""

from phaser_tpu.version import __version__  # noqa: F401
