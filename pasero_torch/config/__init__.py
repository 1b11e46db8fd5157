# Copy of pasero_tpu/config/__init__.py, verbatim.
"""Configuration layer: typed declarative configs, registries, arch zoo."""

from .core import Argument, Config, Field, MISSING, argument
from .registry import (
    CHAT_TEMPLATE_REGISTRY, DATASET_REGISTRY, MODEL_CONFIG_REGISTRY,
    MODEL_REGISTRY, TASK_REGISTRY, get_chat_template, get_dataset_cls,
    get_model_cls, get_model_config_cls, get_task_cls, register_chat_template,
    register_dataset, register_model, register_model_config, register_task,
)
from .common import (
    BLEU_TOKENIZERS, METRICS, DecodingConfig, DistributedConfig, EvalConfig,
    NoiseConfig, PreprocessingConfig, TaskConfig, TrackerConfig,
)
from .models import (
    AdapterHybridTransformerConfig, AdapterTransformerConfig,
    HybridTransformerConfig, MOETransformerConfig, TransformerConfig,
)
from .tasks import (
    DialogueTaskConfig, DocumentLevelTranslationTaskConfig,
    LanguageModelingTaskConfig, NLLBTranslationTaskConfig,
    SpeechTranslationTaskConfig, TranslationTaskConfig, get_task_config_cls,
    register_task_config,
)
from .composed import (
    DebugTrainingDatasetConfig, DecodingAPIConfig, DecodingCLIConfig,
    DynamicTrainingDatasetConfig, SimpleDynamicTrainingDatasetConfig,
    TrainingConfig, TrainingDatasetConfig, get_dataset_config_cls,
    register_dataset_config,
)
from . import archs  # populate the architecture zoo  # noqa: F401
