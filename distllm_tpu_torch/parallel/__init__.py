"""Compute platforms of the port (``launcher``)."""
