"""Mesh server mode: the hop pipeline time- and channel-sharded over a
list of devices in one process (``sharded``), or over the processes of
a cluster (``multihost``)."""

from .sharded import (  # noqa: F401
    ShardedHopPipeline, ShardedHopState, make_mesh, unpack_outputs_sharded,
)
