"""Fixture generators for the port's tests and its on-card check: copies of
tests/datagen.py and tests/benchdata.py on the port's own io, and the
synthetic kernel layouts."""
