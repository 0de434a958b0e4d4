"""repro_torch.core — the named-parameter collective layer on PyTorch.

Ported so far (slice 1): parameters, results, non-blocking results and
request pools, static block splits, the native transport, and the
``allreduce`` / ``allgather`` rows of the op-spec table.
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
from .groups import GroupTables, split_groups, validate_groups
from .nonblocking import NonBlockingResult, RequestPool
from .opspec import OP_TABLE, OpSpec
from .params import (
    Param,
    compression,
    deterministic,
    move,
    op,
    plan,
    recv_buf,
    send_buf,
    send_recv_buf,
    transport,
)
from .spmd import spmd
from .transports import (
    NativeTransport,
    Transport,
    available_transports,
    get_transport,
    register_transport,
)
