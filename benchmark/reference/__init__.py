"""The benchmark's plain reference of the engine: allele assignment (#2)
written afresh over the read arrays the generator wrote the BAMs from, and
a frozen copy of the host route of the later stages (#3-#7) in `engine/`.
It imports nothing of the program under test."""
