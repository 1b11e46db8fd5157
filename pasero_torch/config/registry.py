# Copy of pasero_tpu/config/registry.py; only the comment of the lazy models import differs.
"""Name → class registries for tasks, datasets, models, and architectures.

Equivalent of pasero/config.py:15-139: ``register_task/dataset/model/model_config``
decorators plus lookup helpers. Architecture resolution walks the config-class MRO
so that e.g. a ``llama_7b`` config resolves to the ``transformer`` model family
(pasero/config.py:103-122).
"""

from __future__ import annotations

TASK_REGISTRY: dict[str, type] = {}
DATASET_REGISTRY: dict[str, type] = {}
MODEL_REGISTRY: dict[str, tuple] = {}          # name -> (model_cls, cfg_cls)
MODEL_CONFIG_REGISTRY: dict[str, type] = {}    # arch name -> cfg subclass
CHAT_TEMPLATE_REGISTRY: dict[str, object] = {}


def register_task(name: str):
    def wrapper(cls):
        TASK_REGISTRY[name] = cls
        cls.task_name = name
        return cls
    return wrapper


def register_dataset(name: str):
    def wrapper(cls):
        DATASET_REGISTRY[name] = cls
        return cls
    return wrapper


def register_model(name: str, cfg_cls: type):
    def wrapper(cls):
        MODEL_REGISTRY[name] = (cls, cfg_cls)
        cls.model_name = name
        return cls
    return wrapper


def register_model_config(*names: str):
    def wrapper(cfg_cls):
        for name in names:
            MODEL_CONFIG_REGISTRY[name] = cfg_cls
        cfg_cls.arch_name = names[0]
        return cfg_cls
    return wrapper


def get_task_cls(name: str) -> type:
    if name not in TASK_REGISTRY:
        raise KeyError(f"unknown task {name!r}; available: {sorted(TASK_REGISTRY)}")
    return TASK_REGISTRY[name]


def get_dataset_cls(name: str) -> type:
    if name not in DATASET_REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[name]


def get_model_config_cls(arch: str) -> type:
    if arch not in MODEL_CONFIG_REGISTRY:
        raise KeyError(f"unknown architecture {arch!r}; available: {sorted(MODEL_CONFIG_REGISTRY)}")
    return MODEL_CONFIG_REGISTRY[arch]


def get_model_cls(arch: str) -> tuple:
    """Resolve architecture name to (model_cls, cfg_cls).

    Walks the arch config's MRO to find the closest registered model family
    (pasero/config.py:103-122 does the same with its registry).
    """
    if not MODEL_REGISTRY:
        from .. import models  # registration side effects (lazy: pulls torch)
    cfg_cls = get_model_config_cls(arch)
    for klass in cfg_cls.__mro__:
        for model_cls, registered_cfg in MODEL_REGISTRY.values():
            if registered_cfg is klass:
                return model_cls, cfg_cls
    raise KeyError(f"no registered model family for architecture {arch!r}")


def register_chat_template(name: str, template) -> None:
    CHAT_TEMPLATE_REGISTRY[name] = template


def get_chat_template(name: str):
    if name not in CHAT_TEMPLATE_REGISTRY:
        raise KeyError(f"unknown chat template {name!r}; available: {sorted(CHAT_TEMPLATE_REGISTRY)}")
    return CHAT_TEMPLATE_REGISTRY[name]
