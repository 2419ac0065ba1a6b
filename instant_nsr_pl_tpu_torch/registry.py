"""Name -> class registries wiring configs to components.

The PyTorch port's own registries (a copy of ``instant_nsr_pl_tpu/registry.py``
with separate instances, so both packages can live in one process). Mirrors the reference's registry idiom (datasets/__init__.py:1-16,
models/__init__.py:1-16, systems/__init__.py:1-19): each subsystem keeps a
string registry and classes self-register with a decorator; ``make(name, cfg)``
instantiates by the YAML ``name:`` field.
"""

from __future__ import annotations


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._classes: dict[str, type] = {}

    def register(self, name: str):
        def decorator(cls):
            if name in self._classes and self._classes[name] is not cls:
                raise ValueError(f"{self.kind} '{name}' already registered")
            self._classes[name] = cls
            return cls

        return decorator

    def make(self, name: str, *args, **kwargs):
        if name not in self._classes:
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Known: {sorted(self._classes)}"
            )
        return self._classes[name](*args, **kwargs)

    def get(self, name: str) -> type:
        return self._classes[name]

    def __contains__(self, name):
        return name in self._classes


models = Registry("model")
systems = Registry("system")
datasets = Registry("dataset")
