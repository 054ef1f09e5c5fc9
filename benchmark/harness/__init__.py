"""The benchmark's harness: cells read from BENCHMARK.json and the files
it names, the measured window, the device trace and the checks."""
