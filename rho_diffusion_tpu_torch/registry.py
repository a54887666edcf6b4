"""Global name -> component registry.

The port's own copy of ``rho_diffusion_tpu/registry.py``: the string-to-class
indirection the JSON config system resolves through. Components are named
strings in config files and looked up by category at construction time, with
the same categories and names as the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable


class Registry:
    """A category-partitioned mapping of names to factories/classes."""

    def __init__(self) -> None:
        self.mapping: dict[str, dict[str, Any]] = {
            "models": {},
            "activations": {},
            "layers": {},
            "datasets": {},
            "nn": {},
            "schedules": {},
            "optimizers": {},
            "lr_schedulers": {},
            # metric-logger sinks (TPU-native addition; the reference's
            # MLflow was declared-but-dead, conda.yml:10, ddpm.py:348-354)
            "loggers": {},
        }

    # -- generic machinery ---------------------------------------------------
    def register(self, category: str, name: str | None = None) -> Callable:
        if category not in self.mapping:
            raise KeyError(
                f"Unknown registry category '{category}'; "
                f"expected one of {sorted(self.mapping)}",
            )

        def decorator(obj: Any) -> Any:
            key = name or obj.__name__
            self.mapping[category][key] = obj
            return obj

        return decorator

    def add(self, category: str, name: str, obj: Any) -> None:
        """Imperatively register ``obj`` under ``category/name``."""
        if category not in self.mapping:
            raise KeyError(f"Unknown registry category '{category}'")
        self.mapping[category][name] = obj

    def get(self, category: str, name: str) -> Any:
        """Resolve a registered component; raises with suggestions on miss."""
        if category not in self.mapping:
            raise KeyError(
                f"Unknown registry category '{category}'; "
                f"expected one of {sorted(self.mapping)}",
            )
        table = self.mapping[category]
        if name not in table:
            close = [k for k in table if k.lower() == name.lower()]
            hint = f" Did you mean '{close[0]}'?" if close else ""
            raise KeyError(
                f"'{name}' is not registered under '{category}'."
                f" Available: {sorted(table)}.{hint}",
            )
        return table[name]

    def __contains__(self, item: tuple[str, str]) -> bool:
        category, name = item
        return category in self.mapping and name in self.mapping[category]

    # -- category-specific decorators (reference API parity) -----------------
    def register_model(self, name: str | None = None) -> Callable:
        return self.register("models", name)

    def register_activation(self, name: str | None = None) -> Callable:
        return self.register("activations", name)

    def register_layer(self, name: str | None = None) -> Callable:
        return self.register("layers", name)

    def register_dataset(self, name: str | None = None) -> Callable:
        return self.register("datasets", name)

    def register_nn(self, name: str | None = None) -> Callable:
        return self.register("nn", name)

    def register_schedule(self, name: str | None = None) -> Callable:
        return self.register("schedules", name)

    def register_optimizer(self, name: str | None = None) -> Callable:
        return self.register("optimizers", name)

    def register_lr_scheduler(self, name: str | None = None) -> Callable:
        return self.register("lr_schedulers", name)

    def register_logger(self, name: str | None = None) -> Callable:
        return self.register("loggers", name)


registry = Registry()
