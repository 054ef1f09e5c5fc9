__version__ = "0.1.0"

# Version string of the reference pipeline whose outputs we reproduce.
PHASER_COMPAT_VERSION = "1.2.0"
