"""FID, the Frechet Inception Distance (counterpart of
``basicsr4rs_tpu/metrics/fid.py``; reference: basicsr/metrics/fid.py).

The InceptionV3 features are extracted on the network's device; the
statistics and the Frechet distance are small dense algebra on the host,
in float64 with scipy, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch

from ..archs.inception import LOCAL_FID_WEIGHTS, InceptionV3


def load_patched_inception_v3(weights_path: Optional[str] = None, resize_input: bool = True,
                              normalize_input: bool = False, device=None) -> InceptionV3:
    """The FID InceptionV3 (block 3 only) with pytorch-fid's weights, in eval
    mode on ``device`` (the card unless the caller names another).
    ``weights_path`` is ``pt_inception-2015-12-05-*.pth`` (default: the
    reference's local path); a ``params`` entry is read if the file has one,
    and the classifier's keys are left out. Raises ``FileNotFoundError``
    without the file: FID is meaningless on a random network."""
    weights_path = weights_path or LOCAL_FID_WEIGHTS
    if not os.path.exists(weights_path):
        raise FileNotFoundError(
            f'FID inception weights not found at {weights_path}. Download '
            f'pt_inception-2015-12-05-6726825d.pth (see archs/inception.py) '
            'and point weights_path at it.')
    net = InceptionV3(output_blocks=(3,), resize_input=resize_input,
                      normalize_input=normalize_input)
    ckpt = torch.load(weights_path, map_location='cpu', weights_only=True)
    state_dict = ckpt.get('params', ckpt)
    own = net.state_dict()
    net.load_state_dict({k: v for k, v in state_dict.items() if k in own}, strict=True)
    return net.to(torch.device('cuda') if device is None else device).eval()


@torch.no_grad()
def extract_inception_features(data_generator: Iterable, inception: InceptionV3,
                               len_generator: Optional[int] = None) -> np.ndarray:
    """Pooled block-3 features, (N, 2048) float32 on the host, of a
    generator of NCHW batches (tensors or numpy arrays), each run on the
    network's device. ``len_generator`` is accepted for the reference's
    signature (a progress bar's length)."""
    device = next(inception.parameters()).device
    feats = []
    for data in data_generator:
        x = torch.as_tensor(data, dtype=torch.float32).to(device)
        out = inception(x)[-1]
        feats.append(out.reshape(out.shape[0], -1).cpu().numpy())
    return np.concatenate(feats, axis=0)


def calculate_stats(features: np.ndarray):
    """Sample mean and covariance of a feature matrix (rows are samples)."""
    return np.mean(features, axis=0), np.cov(features, rowvar=False)


def calculate_fid(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance of two Gaussians:
    ``||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))``. A product whose square
    root is not finite is retried with ``eps`` added to both diagonals; an
    imaginary part of the root's diagonal past 1e-3 raises."""
    from scipy import linalg
    if mu1.shape != mu2.shape:
        raise ValueError('Two mean vectors have different lengths')
    if sigma1.shape != sigma2.shape:
        raise ValueError('Two covariances have different dimensions')

    cov_sqrt = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(cov_sqrt).all():
        print(f'Product of cov matrices is singular. Adding {eps} to diagonal of cov estimates')
        offset = np.eye(sigma1.shape[0]) * eps
        cov_sqrt = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))

    if np.iscomplexobj(cov_sqrt):
        if not np.allclose(np.diagonal(cov_sqrt).imag, 0, atol=1e-3):
            m = np.max(np.abs(cov_sqrt.imag))
            raise ValueError(f'Imaginary component {m}')
        cov_sqrt = cov_sqrt.real

    mean_diff = mu1 - mu2
    return float(mean_diff @ mean_diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(cov_sqrt))
