"""phaser_tpu_torch — the PyTorch / CUDA port of phaser_tpu.

Runs phaser_tpu's `phaser` engine with allele assignment on an NVIDIA
Hopper GPU (H100): the Pallas TPU classifier becomes hand-written CUDA
kernels (csrc/alleles.cu), built with nvcc at first use.  The package stands
on its own: it keeps its own copies of phaser_tpu's JAX-free modules (io and
its native library, host engine stages, writers, host mapper, shard
planning) and imports neither jax nor phaser_tpu.

Entry points: `python -m phaser_tpu_torch.cli.phaser_main` (the flags of
`phaser`, with --device cuda|cpu|host) and the downstream tools
`cli.{gene_ae,expr_matrix,cis_var,annotate,mapper}_main`, which need no
pandas (utils/table.py); cis_var's bootstrap runs as torch code
(kernels/bootstrap.py) with --engine torch.  The library entry points run
on the card unless the caller passes device="cpu" or "host".
"""

from .version import __version__  # noqa: F401
