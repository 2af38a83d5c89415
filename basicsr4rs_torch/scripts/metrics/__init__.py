"""Metric scripts: FID of a folder or of a StyleGAN2 generator, and the
Inception statistics of a dataset folder."""
