"""Telemetry of the port: the metrics registry (:mod:`.metrics`)."""
