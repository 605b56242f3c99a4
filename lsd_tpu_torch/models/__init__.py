from .vfe import MeanVFE, PillarVFE, scatter_to_bev
from .bev_backbone import BEVBackbone
from .center_head import CenterHead, decode_boxes
from .detector import CenterPointDetector, DetectorConfig
