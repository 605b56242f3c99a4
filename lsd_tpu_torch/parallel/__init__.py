"""Multi-device execution on ``torch.distributed`` (counterpart of
``lsd_tpu/parallel``): one process per device, the reference's
``shard_map`` programs as SPMD functions whose ``psum``s are
``all_reduce``s over the group."""
from .mesh import Mesh, make_mesh, run_ranks, single_rank
from .schur_pgo import optimize_schur
from .sharded_lio import sharded_lio_update
from .sharded_map import make_sharded_lio_step, sharded_lio_init
from .sharded_pgo import optimize_sharded
