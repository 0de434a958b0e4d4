"""repro_torch.core — the named-parameter collective layer on PyTorch.

Ported: parameters, results, non-blocking results and request pools,
static block splits, the ``native`` and ``ring`` transports, all 16 rows
of the op-spec table with their ``i*`` variants, ``with_flattened`` and
explicit serialization.  Ranks run emulated over a stacked dimension
(``spmd``, the counterpart of ``jax.vmap(axis_name=)``) or per device, one
thread and stream each (``shard_map``, the counterpart of
``jax.shard_map``).
"""
from .communicator import Communicator
from .errors import (
    AssertionLevel,
    KampingError,
    MissingParameterError,
    MovedBufferError,
    ParameterConflictError,
    PendingRequestError,
    UnsupportedParameterError,
    assertion_level,
    set_assertion_level,
)
from .flatten import bucketize_by_destination, flatten_buckets, with_flattened
from .groups import GroupTables, split_groups, validate_groups
from .nonblocking import NonBlockingResult, RequestPool
from .opspec import OP_TABLE, OpSpec
from .params import (
    Param,
    axis,
    compression,
    dest,
    deterministic,
    grow_only,
    move,
    no_resize,
    op,
    plan,
    recv_buf,
    recv_count,
    recv_count_out,
    recv_counts,
    recv_counts_out,
    recv_displs,
    recv_displs_out,
    resize_to_fit,
    root,
    send_buf,
    send_count,
    send_counts,
    send_counts_out,
    send_displs,
    send_displs_out,
    send_recv_buf,
    source,
    tag,
    transport,
)
from .result import Result
from .serialization import (
    Serialized,
    as_deserializable,
    as_serialized,
    deserialize,
    deserialize_like,
    host_pack,
    host_unpack,
)
from .shard import shard_map
from .spmd import spmd
from .transports import (
    NativeTransport,
    RingTransport,
    Transport,
    available_transports,
    get_transport,
    register_transport,
)
