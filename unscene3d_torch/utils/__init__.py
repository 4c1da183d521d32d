"""Host-side utilities of the port: the metric loggers."""
