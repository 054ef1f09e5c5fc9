"""A frozen copy of the host route of phaser_tpu_torch's stages #3-#7 and
of the VCF filter #1 (io/vcf.py, engine/varmap.py), as the reference runs
them; the device paths are left out."""
