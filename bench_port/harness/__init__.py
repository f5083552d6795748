"""The harness: cell specs, traffic, the serving window, traces, metrics and the
output check. Nothing here is specific to one cell."""
