"""Trace exporters of the port's runtime telemetry (``perf.trace``)."""
