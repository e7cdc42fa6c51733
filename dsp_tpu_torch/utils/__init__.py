"""Utilities of the port: device timing on the card (``timing``), logging,
one-time warnings and run metrics (``logging``)."""
