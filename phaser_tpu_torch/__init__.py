"""phaser_tpu_torch — the PyTorch / CUDA port of phaser_tpu.

Runs phaser_tpu's `phaser` engine with allele assignment on an NVIDIA
Hopper GPU (H100): the Pallas TPU classifier becomes hand-written CUDA
kernels (csrc/alleles.cu), built with nvcc at first use.  The package stands
on its own: it keeps its own copies of phaser_tpu's JAX-free modules (io and
its native library, host engine stages, writers, host mapper, shard
planning) and imports neither jax nor phaser_tpu.

Entry point: `python -m phaser_tpu_torch.cli.phaser_main` (the flags of
`phaser`, with --device cuda|cpu|host).  The library entry points run on the
card unless the caller passes device="cpu" or "host".
"""

from .version import __version__  # noqa: F401
