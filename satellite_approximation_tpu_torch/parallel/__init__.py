"""Multi-device execution: meshes of shards, halo exchange, sharded solvers
and sharded detection stages (``satellite_approximation_tpu/parallel``).

One process drives every shard, as the JAX package's single controller
does: a :class:`ShardMesh` holds one device per shard (a device may hold
several shards), halos move by device-to-device copies and reductions sum
in shard order. Bands shard over the 'b' axis; image rows over 'x' (rows
over 'y' and columns over 'x' on a 2-D mesh). The multi-process form
(``multihost.py``, :func:`dcn_dryrun`) starts ``torch.distributed``, and
its mesh spans the processes (``mesh.init_process_mesh``): the sharded
MG-PCG runs across them; the other sharded functions refuse such a mesh.
"""

from .dryrun import dryrun_multichip
from .fill import sharded_fill
from .halo import halo_pad_cols, halo_pad_rows
from .mesh import ShardMesh, auto_fill_mesh, make_mesh, resolve_mesh, spatial_band_mesh, spatial_mesh_2d
from .mg import sharded_mg_solve, sharded_mg_solve_2d
from .multihost import dcn_dryrun
from .solver import sharded_masked_cg, sharded_training_step

__all__ = [
    "ShardMesh",
    "make_mesh",
    "spatial_band_mesh",
    "spatial_mesh_2d",
    "auto_fill_mesh",
    "resolve_mesh",
    "halo_pad_rows",
    "halo_pad_cols",
    "sharded_masked_cg",
    "sharded_training_step",
    "sharded_mg_solve",
    "sharded_mg_solve_2d",
    "sharded_fill",
    "dryrun_multichip",
    "dcn_dryrun",
]
