"""Synthetic data for the port (numpy only)."""
