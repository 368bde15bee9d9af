"""The statement server of the port (``protocol.py``: HTTP front door,
admission through ``resource_groups.py``) and its security
(``security.py``: authenticators, access control and roles)."""
from .protocol import PrestoTpuServer, StatementServer
from .resource_groups import (
    QueryQueuedTimeoutError, QueryQueueFullError, ResourceGroupManager,
)

__all__ = ["PrestoTpuServer", "StatementServer", "ResourceGroupManager",
           "QueryQueueFullError", "QueryQueuedTimeoutError"]
