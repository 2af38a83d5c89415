"""L2S datasets with histogram-matched Sentinel targets (counterpart of
``basicsr4rs_tpu/data/l2s_single_hm_dataset.py``; reference:
basicsr/data/l2s_single_hm_dataset.py)."""

from __future__ import annotations

from ..utils.registry import DATASET_REGISTRY
from .l2s_single_dataset import L2SSingleDataset, L2SSingleSplitDataset


@DATASET_REGISTRY.register()
class L2SSingleHMDataset(L2SSingleDataset):
    """The GT comes from ``sentinel_hm``, the samples are filtered by
    ``metric_hm.json``."""
    gt_source = 'sentinel_hm'
    use_hm_metrics = True


@DATASET_REGISTRY.register()
class L2SSingleHMSplitDataset(L2SSingleSplitDataset):
    base_class = L2SSingleHMDataset
