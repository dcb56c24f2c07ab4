"""Serving runtime of the port: cell plan, stream engine, tick, metrics."""
