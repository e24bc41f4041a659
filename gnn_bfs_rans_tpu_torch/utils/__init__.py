"""Benchmarking, roofline accounting, device traces, synthetic grids and
profiling aids."""
