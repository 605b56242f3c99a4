from .state import NavState, ERR_DIM, boxplus, boxminus, init_state
from .lio import LioConfig, LioState, lio_init, lio_step, lio_step_batch
from .posegraph import PgoConfig, PoseGraphData, optimize
from .graph_builder import PoseGraphBuilder
from .keyframe import Keyframe, KeyframeStore, KeyframeUpdater
from .scancontext import make_descriptor, sc_db_create, sc_db_add, sc_query
from .registration import icp_point_to_plane, ndt_build, ndt_align, NdtMap
from .ukf import UkfConfig, UkfState, ukf_init, ukf_predict, ukf_correct, ukf_pose
from .mapper import Mapper, MapperConfig
from .rtkm import RtkMapper
from .localization import Localizer, LocalizerConfig
from . import map_io
