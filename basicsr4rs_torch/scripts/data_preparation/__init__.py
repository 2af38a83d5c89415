"""Data preparation scripts: sub-images, bicubic LR images, meta-info
files, LMDB folders, REDS regrouping, HiFaceGAN degradation pairs and
images from TFRecords. None of them imports a network."""
