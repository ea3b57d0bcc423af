"""Model families of the port (dense decoder so far)."""
