"""Convert a Flax parameter tree of the JAX package into a torch state_dict.

The inverse of ``basicsr4rs_tpu/utils/torch_convert.py``: it takes the nested
dict of numpy arrays that the JAX package's modules hold and returns the
BasicSR-keyed ``state_dict`` that the port's ``nn.Module``s load. Rules:

* conv kernel (kH, kW, I, O) -> weight (O, I, kH, kW); 1-d (kW, I, O) -> (O, I, kW);
  3-d (kD, kH, kW, I, O) -> (O, I, kD, kH, kW); ECBSR's ``k0`` and ``k1``
  likewise, under their own names
* dense kernel (in, out)     -> weight (out, in)
* ``kernel`` and the norms' ``scale`` -> ``weight``
* BatchNorm ``batch_stats`` (``mean``, ``var``) -> ``running_mean``,
  ``running_var``, and a ``num_batches_tracked`` of 0 beside them
* module-list names ``a_0.b`` -> ``a.0.b``
* then the architecture's own ``rules``: ``(regex, replacement)`` pairs on
  the dotted key: each architecture of the port keeps its own as
  ``JAX_KEY_RULES`` (``SwinIR``, the diffusion UNets, the first-stage
  autoencoders, ``IconVSR``), the inverse of the JAX module's
  ``TORCH_KEY_RULES``.

Arrays go in as numpy (never JAX arrays), so the port needs no JAX.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def jax_path_to_torch_key(path: Sequence[str],
                          rules: Optional[Sequence[Tuple[str, Any]]] = None) -> str:
    """Flax param path -> torch state_dict key."""
    parts = list(path)
    if parts[-1] in ('kernel', 'scale'):
        parts[-1] = 'weight'
    key = '.'.join(parts)
    # a_2_0.b -> a.2.0.b, innermost index first
    while re.search(r'_(\d+)(?=\.|$)', key):
        key = re.sub(r'_(\d+)(?=\.|$)', r'.\1', key)
    for pattern, repl in (rules or ()):
        key = re.sub(pattern, repl, key)
    return key


def convert_array(leaf: str, arr: np.ndarray) -> np.ndarray:
    """Flax layout -> torch layout for one leaf named ``leaf``."""
    if leaf in ('kernel', 'k0', 'k1'):
        if arr.ndim == 5:   # DHWIO -> OIDHW
            return np.transpose(arr, (4, 3, 0, 1, 2))
        if arr.ndim == 4:   # HWIO -> OIHW
            return np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 3:   # conv1d WIO -> OIW
            return np.transpose(arr, (2, 1, 0))
        if arr.ndim == 2:   # (in, out) -> (out, in)
            return np.transpose(arr, (1, 0))
    return arr


_STATS = {'mean': 'running_mean', 'var': 'running_var'}


def jax_params_to_state_dict(params: Mapping[str, Any],
                             rules: Optional[Sequence[Tuple[str, Any]]] = None,
                             batch_stats: Optional[Mapping[str, Any]] = None
                             ) -> 'OrderedDict[str, torch.Tensor]':
    """Nested Flax params (numpy leaves), and the ``batch_stats``
    collection where the network has one, -> torch state_dict (CPU tensors)."""
    state_dict: 'OrderedDict[str, torch.Tensor]' = OrderedDict()
    for path, value in _flatten(params):
        arr = convert_array(path[-1], np.asarray(value))
        state_dict[jax_path_to_torch_key(path, rules)] = torch.from_numpy(np.array(arr))
    for path, value in _flatten(batch_stats or {}):
        key = jax_path_to_torch_key(path[:-1] + (_STATS[path[-1]],), rules)
        state_dict[key] = torch.from_numpy(np.array(value, np.float32))
        state_dict[key.rsplit('.', 1)[0] + '.num_batches_tracked'] = torch.tensor(0)
    return state_dict
