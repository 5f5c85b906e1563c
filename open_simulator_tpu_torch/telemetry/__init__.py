"""Telemetry surfaces of the port: the explain report."""
