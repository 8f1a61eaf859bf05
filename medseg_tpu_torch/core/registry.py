"""Model registry keyed by the reference's model names (case-insensitive,
like the reference's `.lower()` dispatch)."""

from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register_model(name: str, task: str, **meta):
    """Decorator registering a model factory under `name`.

    task: "classification" or "segmentation".
    """

    def wrap(factory: Callable):
        _REGISTRY[name.lower()] = {"name": name, "task": task,
                                   "factory": factory, **meta}
        return factory

    return wrap


def _ensure_zoo_loaded():
    """Importing the models package populates the registry."""
    if not _REGISTRY:
        import medseg_tpu_torch.models  # noqa: F401


def get_model(name: str) -> Dict[str, Any]:
    _ensure_zoo_loaded()
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown model: {name}. Registered: "
            f"{sorted(e['name'] for e in _REGISTRY.values())}")
    return _REGISTRY[key]
