"""Model families of the port: the dense decoder, the mamba2 SSM tower and
the zamba2-style hybrid."""
