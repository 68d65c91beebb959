from .build import build_detector, build_engine
from .engine import (EngineConfig, TwoStageEngine, refine_boxes,
                     tta_flip_average)

__all__ = ['build_detector', 'build_engine', 'EngineConfig', 'TwoStageEngine',
           'refine_boxes', 'tta_flip_average']
