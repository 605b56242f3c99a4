from .data import SyntheticDetectionDataset, SyntheticSceneConfig
