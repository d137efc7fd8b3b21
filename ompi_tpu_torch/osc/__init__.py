"""osc — one-sided communication (RMA windows).  See :mod:`.win`."""

from .component import ArenaOscComponent  # noqa: F401
from .win import (  # noqa: F401
    FLAVOR_ALLOCATE,
    FLAVOR_CREATE,
    FLAVOR_DYNAMIC,
    FLAVOR_SHARED,
    LOCK_EXCLUSIVE,
    LOCK_SHARED,
    MODE_NOCHECK,
    MODE_NOPRECEDE,
    MODE_NOPUT,
    MODE_NOSTORE,
    MODE_NOSUCCEED,
    MODEL_UNIFIED,
    RMARequest,
    Win,
)
