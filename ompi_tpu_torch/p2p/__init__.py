"""Point-to-point layer: the pml matching engine and its components
(``eager``; ``vprotocol`` message logging; partitioned and persistent
channels in :mod:`.part`)."""

from . import vprotocol  # noqa: F401  (component registration)
from .component import EagerPmlComponent  # noqa: F401
from .pml import (  # noqa: F401
    ANY_SOURCE,
    ANY_TAG,
    PROC_NULL,
    MatchingEngine,
    RecvRequest,
    Status,
)
