"""Distribution substrate of the port: meshes, sharding rules and
placement, logical-axis annotations, compressed collectives, mesh-sharded
plan and program execution, sharded model steps, and the
fault-tolerance policies.

One controller runs every shard: a ``mesh.Mesh`` is an array of
``torch.device`` s (a device may repeat), and ``mesh_exec`` runs each
shard's work on its device and copies blocks between shards itself.
"""

from repro_torch.dist import (annotate, collectives, fault,  # noqa: F401
                              mesh, mesh_exec, sharding, spmd)
from repro_torch.dist.mesh import Mesh, make_mesh  # noqa: F401
