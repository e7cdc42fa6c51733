"""Utilities of the port: device timing on the card (``timing``)."""
