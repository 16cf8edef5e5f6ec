"""The benchmark's yardstick: the load generators, the trace reduction, the
operation counts, the peaks and the comparison that decides ``correct``."""
