"""The port's benchmark harness: cells, window, trace, reference and check."""
