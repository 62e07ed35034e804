"""repro_torch.dist — the CEP operator's scale-out over torch.distributed.

Port of the CEP half of ``repro.dist``: pattern parallelism (the PM store
split on its pattern axis, ``run_engine_sharded``) and lane parallelism
(tenant lanes over a mesh dim, composed with a pattern split on a 2-D
mesh, ``run_chunk_lanes_sharded``).  ``mesh`` holds the meshes and the
rank worlds; ``sharding`` the specs, the merge and the sharded steps.
"""
from repro_torch.dist.mesh import (AbstractMesh, RankError, abstract_mesh,
                                   axis_group, axis_rank, axis_size,
                                   broadcast_object, init_mesh, mesh_rank,
                                   spawn, world_mesh)
from repro_torch.dist.sharding import (lane_specs, merge_shards_plain,
                                       pm_specs, run_chunk_lanes_plain,
                                       run_chunk_lanes_sharded,
                                       run_engine_shards_plain,
                                       run_engine_sharded, stats)
