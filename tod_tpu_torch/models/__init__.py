from tod_tpu_torch.models.detector import TodDetector
from tod_tpu_torch.models.trainer import TodTrainer
from tod_tpu_torch.models.fused import FusedDetector, FusedDetectorConfig

__all__ = ["TodDetector", "TodTrainer", "FusedDetector",
           "FusedDetectorConfig"]
