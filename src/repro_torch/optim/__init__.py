"""Optimizers of the port: Adam (``adam``)."""
