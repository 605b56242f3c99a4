from .data import LabeledFrameDataset, SyntheticDetectionDataset, SyntheticSceneConfig
from .trainer import Trainer, TrainerConfig
