"""repro_torch.serve — continuous-batching serving (DESIGN.md §11)."""
from .engine import REPLICA_AXIS, Request, ServeEngine

__all__ = ["REPLICA_AXIS", "Request", "ServeEngine"]
