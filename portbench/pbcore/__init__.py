"""The harness of the port's benchmark: cells, traffic, the measured
window, the trace's reduction and the result line."""
