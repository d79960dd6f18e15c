"""Measurement scripts for the port, run from a checkout on the card."""
