"""Command-line drivers: the serial CMIGBench generation loop."""
