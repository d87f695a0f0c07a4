"""LLICTI: learned lossless image compression in JAX.

Re-designed from scratch for JAX/XLA/Pallas on an accelerator, with the
capability surface of the reference LLICTI codebase (scale-based auto-regressive
lossless codec: lazy wavelet pyramid + CNN interpolators + GMM entropy
model + arithmetic coding).
"""
from .config import (
    DataConfig,
    LLICTIConfig,
    ModelConfig,
    TrainConfig,
    config_from_dict,
    config_from_json,
)

__version__ = "0.1.0"
