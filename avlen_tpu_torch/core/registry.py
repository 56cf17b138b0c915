"""Global component registry (a copy of avlen_tpu/core/registry.py).

Single name→class registry covering the roles the reference splits across
`habitat.core.registry.Registry` (habitat-lab-dialog/habitat/core/registry.py:39)
and `BaselineRegistry` (ss_baselines/common/baseline_registry.py:30): tasks,
simulators, sensors, measures, datasets, trainers, and RL envs are all selected
by string name from config.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, DefaultDict, Dict, Optional, Type


class Registry:
    """Name→class maps keyed by component kind.

    Usage::

        @registry.register_sensor
        class SpectrogramSensor: ...

        @registry.register_trainer(name="avnav")
        class AVNavTrainer: ...

        cls = registry.get_sensor("SpectrogramSensor")
    """

    def __init__(self) -> None:
        self._map: DefaultDict[str, Dict[str, Any]] = collections.defaultdict(dict)

    def _register(self, kind: str, to_register: Optional[Type] = None, *, name: Optional[str] = None):
        def wrap(cls: Type) -> Type:
            register_name = name if name is not None else cls.__name__
            self._map[kind][register_name] = cls
            return cls

        if to_register is None:
            return wrap
        return wrap(to_register)

    def _get(self, kind: str, name: str) -> Any:
        if name not in self._map[kind]:
            known = sorted(self._map[kind])
            raise KeyError(f"No {kind} registered under {name!r}. Known: {known}")
        return self._map[kind][name]

    # -- component kinds -------------------------------------------------
    def register_task(self, to_register=None, *, name=None):
        return self._register("task", to_register, name=name)

    def register_simulator(self, to_register=None, *, name=None):
        return self._register("simulator", to_register, name=name)

    def register_sensor(self, to_register=None, *, name=None):
        return self._register("sensor", to_register, name=name)

    def register_measure(self, to_register=None, *, name=None):
        return self._register("measure", to_register, name=name)

    def register_dataset(self, to_register=None, *, name=None):
        return self._register("dataset", to_register, name=name)

    def register_trainer(self, to_register=None, *, name=None):
        return self._register("trainer", to_register, name=name)

    def register_env(self, to_register=None, *, name=None):
        return self._register("env", to_register, name=name)

    def register_model(self, to_register=None, *, name=None):
        return self._register("model", to_register, name=name)

    def get_task(self, name: str):
        return self._get("task", name)

    def get_simulator(self, name: str):
        return self._get("simulator", name)

    def get_sensor(self, name: str):
        return self._get("sensor", name)

    def get_measure(self, name: str):
        return self._get("measure", name)

    def get_dataset(self, name: str):
        return self._get("dataset", name)

    def get_trainer(self, name: str):
        return self._get("trainer", name)

    def get_env(self, name: str):
        return self._get("env", name)

    def get_model(self, name: str):
        return self._get("model", name)

    def names(self, kind: str):
        return sorted(self._map[kind])


registry = Registry()
