"""Metric scripts: FID of a folder or of a StyleGAN2 generator, the
Inception statistics of a dataset folder, PSNR / SSIM, NIQE and LPIPS of a
folder, and back-projection refinement of SR outputs."""
