"""Per-architecture configs (the port's copy of ``repro.configs``)."""
from .base import ARCH_IDS, ModelConfig, ParallelConfig, all_configs, get_config, reduced, register
