"""The benchmark's input generator: a donor's VCF and read BAMs made from
a configuration, a traffic mix and a seed, with numpy and zlib alone."""
