"""Measurement scripts of the port, run as modules from the repository root."""
