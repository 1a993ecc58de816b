"""Measurement scripts for the card, run as ``python -m``."""
