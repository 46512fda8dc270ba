"""Models of the port (the StyleGAN2 generator in this slice)."""
