"""DCN layer: inter-process/inter-slice transport + collectives
(≈ opal/mca/btl/tcp + the host side of coll/han, SURVEY.md §2.7)."""

from .collops import DcnCollEngine  # noqa: F401
from .tcp import TcpTransport  # noqa: F401
