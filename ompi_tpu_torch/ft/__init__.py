"""Fault tolerance — ULFM semantics (revoke/shrink/agree) and the
multi-process failure detector (SURVEY.md §5 failure detection)."""

from ompi_tpu_torch.ft.ulfm import (
    FTState,
    ack_failed,
    agree,
    check,
    get_failed,
    inject_failure,
    is_revoked,
    peek,
    revoke,
    shrink,
    state,
)

__all__ = [
    "FTState",
    "ack_failed",
    "agree",
    "check",
    "get_failed",
    "inject_failure",
    "is_revoked",
    "peek",
    "revoke",
    "shrink",
    "state",
]
