"""The L2S dataset normalised by each band's mean +- one std (counterpart of
``basicsr4rs_tpu/data/l2s_single_mean2std_dataset.py``; reference:
basicsr/data/l2s_single_dataset_mean_2std.py, an unregistered duplicate
there, registered under its own name in both packages)."""

from __future__ import annotations

from ..utils.registry import DATASET_REGISTRY
from .l2s_single_dataset import L2SSingleDataset, L2SSingleSplitDataset
from .transforms import build_normalizer

# per-band statistics of the reference (l2s_single_dataset_mean_2std.py:37-80)
LANDSAT_MEAN_STD = {
    'blue': {'mean': 9563.7984, 'std': 2961.4631},
    'green': {'mean': 10615.2811, 'std': 2908.3771},
    'red': {'mean': 10721.1473, 'std': 3259.4143},
    'nir08': {'mean': 14673.4545, 'std': 4900.9225},
    'swir16': {'mean': 13539.8734, 'std': 3882.9049},
    'swir22': {'mean': 11925.1374, 'std': 3245.9576},
}
SENTINEL_MEAN_STD = {
    'blue': {'mean': 795.0896, 'std': 789.0347},
    'green': {'mean': 985.7132, 'std': 759.0325},
    'red': {'mean': 1035.7568, 'std': 842.9308},
    'nir08': {'mean': 2212.2311, 'std': 1290.3774},
    'swir16': {'mean': 1912.4766, 'std': 1082.7832},
    'swir22': {'mean': 1444.6185, 'std': 942.3633},
}
RGB, NSS = ['red', 'green', 'blue'], ['nir08', 'swir16', 'swir22']


@DATASET_REGISTRY.register()
class L2SSingleMean2StdDataset(L2SSingleDataset):
    """``landsat_mean_std`` / ``sentinel_mean_std`` in the options replace
    the tables above."""

    def __init__(self, opt):
        super().__init__(opt)
        landsat_stats = opt.get('landsat_mean_std', LANDSAT_MEAN_STD)
        sentinel_stats = opt.get('sentinel_mean_std', SENTINEL_MEAN_STD)
        self.landsat_rgb_norm = build_normalizer(landsat_stats, RGB)
        self.landsat_nss_norm = build_normalizer(landsat_stats, NSS)
        self.sentinel_rgb_norm = build_normalizer(sentinel_stats, RGB)
        self.sentinel_nss_norm = build_normalizer(sentinel_stats, NSS)


@DATASET_REGISTRY.register()
class L2SSingleMean2StdSplitDataset(L2SSingleSplitDataset):
    base_class = L2SSingleMean2StdDataset
