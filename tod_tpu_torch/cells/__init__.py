from tod_tpu_torch.cells.types import MatchSet, PoseResult
from tod_tpu_torch.cells.features import (
    FeatureDescriptor,
    DepthTo3d,
    RescaledRegisteredDepth,
)
from tod_tpu_torch.cells.matcher import DescriptorMatcher, MatcherIndex
from tod_tpu_torch.cells.guess import GuessGenerator
from tod_tpu_torch.cells.serving import SegmentedDetector
from tod_tpu_torch.cells.trainer import Trainer, ModelFiller
from tod_tpu_torch.cells.readers import (ModelReader, ModelReaderIterative,
                                         ModelWriter)
from tod_tpu_torch.cells.io import (
    Aggregator,
    Constant,
    Dealer,
    DatasetSource,
    PassthroughN,
    Publisher,
)

__all__ = [
    "MatchSet", "PoseResult",
    "FeatureDescriptor", "DepthTo3d", "RescaledRegisteredDepth",
    "DescriptorMatcher", "MatcherIndex", "GuessGenerator",
    "SegmentedDetector", "Trainer", "ModelFiller",
    "ModelReader", "ModelReaderIterative", "ModelWriter",
    "Aggregator", "Constant", "Dealer", "DatasetSource", "PassthroughN",
    "Publisher",
]
