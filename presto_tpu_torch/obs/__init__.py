"""Observability of the port: the process-wide metrics registry."""
