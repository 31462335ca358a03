"""Scale-out: the shard mesh, the hash-partitioned shuffle and the
distributed operators (counterpart of arrow_tpu/parallel/__init__.py).
The bodies take a communicator bound to one shard where the reference's
take a mesh axis: `LocalMesh` (shards as threads of this process, on
one device or several) through `shard_map`, or `ProcessGroupComm` (one
process a shard over torch.distributed)."""

from .mesh import (make_mesh, shard_axis, table_sharding,  # noqa: F401
                   RowSplit, LocalMesh, ProcessGroupComm, shard_map)
from .partition import (  # noqa: F401
    hash_u64, bucketize, exchange, repartition_arrays, ShuffleResult,
)
from .dist import (  # noqa: F401
    local_group_aggregate, dist_group_by, dist_group_by_stream,
    dist_join_unique,
    dist_join, dist_join_stream, dist_join_skew, dist_sort,
    dist_sum,
)
from .api import (  # noqa: F401
    dist_table_group_by, dist_table_sort, dist_table_join,
    pack_key_columns,
)
