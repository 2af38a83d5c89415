"""String-keyed registries used by the config-driven builders.

Counterpart of ``basicsr4rs_tpu/utils/registry.py`` (reference:
basicsr/utils/registry.py:4-88). ``@DATASET_REGISTRY.register()`` decorators
populate name->callable maps that the ``build_*`` factories look up by the
YAML ``type`` key; registries support suffix fallbacks used when a
user config refers to the upstream name of a class we ship under a suffixed
name (reference behavior at basicsr/utils/registry.py:58-66).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple


class Registry:
    """A name -> object mapping supporting decorator-based registration.

    Example::

        ARCH_REGISTRY = Registry('arch')

        @ARCH_REGISTRY.register()
        class MSRResNet(nn.Module):
            ...

        cls = ARCH_REGISTRY.get('MSRResNet')
    """

    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise KeyError(
                f"An object named '{name}' is already registered in the "
                f"'{self._name}' registry!")
        self._obj_map[name] = obj

    def register(self, obj: Optional[Any] = None, name: Optional[str] = None) -> Callable:
        """Register ``obj`` (or use as a decorator when ``obj`` is None)."""
        if obj is None:
            def decorator(fn_or_class: Any) -> Any:
                self._do_register(name or fn_or_class.__name__, fn_or_class)
                return fn_or_class
            return decorator
        self._do_register(name or obj.__name__, obj)
        return obj

    def get(self, name: str, suffix: str = 'basicsr4rs_torch') -> Any:
        """Look up ``name``; fall back to ``name_{suffix}`` like the reference
        suffix-registration scheme (basicsr/utils/registry.py:58-66)."""
        obj = self._obj_map.get(name)
        if obj is None and suffix:
            obj = self._obj_map.get(f'{name}_{suffix}')
        if obj is None:
            raise KeyError(
                f"No object named '{name}' found in the '{self._name}' registry! "
                f"Registered: {sorted(self._obj_map)}")
        return obj

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()

    def __len__(self) -> int:
        return len(self._obj_map)

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={sorted(self._obj_map)})"


DATASET_REGISTRY = Registry('dataset')
ARCH_REGISTRY = Registry('arch')
MODEL_REGISTRY = Registry('model')
LOSS_REGISTRY = Registry('loss')
METRIC_REGISTRY = Registry('metric')
