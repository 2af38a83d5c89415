"""Official-checkpoint conversion: the official key names of EDSR, RCAN,
ESRGAN, EDVR, DUF, RIDNet, StyleGAN2 and DFDNet checkpoints renamed to
BasicSR's, written as a ``.pth`` under ``params``."""
