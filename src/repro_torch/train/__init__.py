"""Serving steps of the port (``serve``); training is not ported yet."""
