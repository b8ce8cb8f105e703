"""Serving entry points of the port (``steps``, ``serve``)."""
