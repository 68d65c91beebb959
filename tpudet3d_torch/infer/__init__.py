from .build import build_detector, build_engine
from .engine import (EngineConfig, TwoStageEngine, refine_boxes,
                     tta_flip_average)
from .tracker import IOUTracker, IOUTrackerConfig, Track, TrackedObj
from .wrappers import Detector, Regressor

__all__ = ['build_detector', 'build_engine', 'EngineConfig', 'TwoStageEngine',
           'refine_boxes', 'tta_flip_average', 'IOUTracker',
           'IOUTrackerConfig', 'Track', 'TrackedObj', 'Detector', 'Regressor']
