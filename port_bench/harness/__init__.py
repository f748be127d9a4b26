"""The harness: finds a cell's files by name, makes its inputs from the
seed, times the window, reads the trace and decides ``correct``."""
