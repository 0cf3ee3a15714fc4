"""Serving runtime, port of ``repro.serve``: continuous-batching replicas
behind a NetClone dispatcher."""

from repro_torch.serve.engine import Completion, DecodeReplica, ServeRequest
from repro_torch.serve.server import NetCloneServer, ServeStats

__all__ = [
    "DecodeReplica",
    "ServeRequest",
    "Completion",
    "NetCloneServer",
    "ServeStats",
]
