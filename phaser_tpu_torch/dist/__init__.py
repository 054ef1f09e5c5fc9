"""Subpackage of phaser_tpu_torch; see the package docstring."""
