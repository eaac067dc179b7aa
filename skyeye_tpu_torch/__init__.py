"""SkyEye on PyTorch and CUDA: the port of ``skyeye_tpu`` to an NVIDIA H100.

Imports torch and numpy only. Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
from .api import Results, SkyEyeDetector
from .config import ModelConfig, load_model_config
from .models.detector import SkyEyeDetectorModule, create_detector

__all__ = ["Results", "SkyEyeDetector", "ModelConfig", "load_model_config",
           "SkyEyeDetectorModule", "create_detector"]
