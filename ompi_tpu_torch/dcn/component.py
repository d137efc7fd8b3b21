"""``btl/tcp`` MCA component — the DCN transport's tunables.

≈ ``opal/mca/btl/tcp``'s component registration (SURVEY.md §2.3: the
btl framework row — "the slot where a DCN transport goes in the
rebuild").  The transport itself is :mod:`ompi_tpu_torch.dcn.tcp`; this
component owns its MCA variables, mirroring the reference's
``btl_tcp_eager_limit`` / ``btl_tcp_max_send_size`` knob family and
the pml-level eager↔rendezvous switch (SURVEY.md §2.2 pml ob1).

Port of ``ompi_tpu/dcn/component.py``: ``btl/native`` (the C++ data
plane, the default wherever ``libtpudcn`` builds, as in the reference),
``btl/tcp``, ``btl/sm`` and ``btl/bml``.  The reference layers its
device-resident plane above whichever btl is selected; the port has no
device plane, so every payload byte moves over the selected btl.
"""

from __future__ import annotations

from ompi_tpu_torch.core.registry import Component, register_component


@register_component
class DcnTcpComponent(Component):
    FRAMEWORK = "btl"
    NAME = "tcp"
    PRIORITY = 50

    def register_params(self, store) -> None:
        super().register_params(store)
        store.register(
            "btl", "tcp", "eager_limit", 4 << 20, type="int",
            help="Largest payload (bytes) sent as a single EAGER frame; "
            "larger transfers use the RTS/CTS rendezvous protocol "
            "(≈ btl_tcp_eager_limit + ob1's rendezvous switch)",
        )
        store.register(
            "btl", "tcp", "frag_size", 8 << 20, type="int",
            help="Fragment size (bytes) for rendezvous streaming "
            "(≈ btl_tcp_max_send_size)",
        )
        store.register(
            "btl", "tcp", "max_rndv", 4, type="int",
            help="Max concurrent inbound rendezvous transfers a process "
            "grants CTS for (flow control on DCN ingress memory)",
        )
        store.register(
            "btl", "tcp", "ring_threshold", 64 << 10, type="int",
            help="Payload size (bytes) at which DCN allreduce switches "
            "from the ordered gather-to-root fold to the bandwidth-"
            "optimal ring reduce-scatter + allgather schedule "
            "(commutative ops only; ordered fold is kept for "
            "non-commutative/reproducible reductions)",
        )

    def params(self, store) -> dict:
        """Final knob dict for engine construction.  Subclasses extend
        :meth:`_collect_params`, NOT this method: the trace marker must
        fire once with the COMPLETE dict (shm_threshold/ring_bytes
        included), so it lives here at the outermost call."""
        p = self._collect_params(store)
        from ompi_tpu_torch.trace import core as _tr

        if _tr._enabled:
            _tr.instant("dcn", "transport_params",
                        **dict(p, transport=self.NAME))
        return p

    def _collect_params(self, store) -> dict:
        self.register_params(store)
        return {
            "eager_limit": store.get("btl_tcp_eager_limit"),
            "frag_size": store.get("btl_tcp_frag_size"),
            "max_rndv": store.get("btl_tcp_max_rndv"),
            "ring_threshold": store.get("btl_tcp_ring_threshold"),
        }


@register_component
class DcnShmComponent(DcnTcpComponent):
    """``btl/sm`` — same-host shared-memory transport (single-copy bulk
    payloads over /dev/shm, abstract unix sockets for framing).

    Priority below tcp: the modex address only resolves on one host, so
    the reference's reachability logic collapses to explicit selection
    (``--mca btl sm``) until the multi-host launch leg exists.
    Inherits the tcp knob family; adds the copy-in threshold.
    """

    NAME = "sm"
    PRIORITY = 40

    def register_params(self, store) -> None:
        super().register_params(store)
        store.register(
            "btl", "sm", "shm_threshold", 2 << 20, type="int",
            help="Smallest payload (bytes) moved through the shared-"
            "memory ring instead of inline on the unix socket (measured "
            "crossover: kernel socket copies win below ~2 MiB)",
        )

    def _collect_params(self, store) -> dict:
        p = super()._collect_params(store)
        p["transport"] = "sm"
        p["shm_threshold"] = store.get("btl_sm_shm_threshold")
        return p


@register_component
class DcnBmlComponent(DcnShmComponent):
    """``btl/bml`` — the r2-style per-peer multiplexer: shared-memory
    rings for same-host peers, TCP for cross-host, chosen per SEND by
    the peer's advertised host identity (SURVEY.md §2.3 bml row).
    Select with ``--mca btl bml``; the default stays single-transport
    until mixed-host jobs are routinely launched (the rsh leg)."""

    NAME = "bml"
    PRIORITY = 45

    def _collect_params(self, store) -> dict:
        p = super()._collect_params(store)
        p["transport"] = "bml"
        return p


@register_component
class DcnNativeComponent(DcnTcpComponent):
    """``btl/native`` — the C++ host data plane (``libtpudcn.so``, built
    from ``csrc/dcn.cc``): native framing, shared-memory rings + TCP per
    peer (the bml role), and the C matching engine under blocked
    receives.  Highest priority: selected by default; ``--mca btl
    tcp|sm|bml`` still forces a Python transport."""

    NAME = "native"
    PRIORITY = 60

    def register_params(self, store) -> None:
        super().register_params(store)
        store.register(
            "btl", "native", "ring_bytes", 64 << 20, type="int",
            help="Per-peer-direction shared-memory ring capacity "
            "(bytes); payloads beyond half of this stream as chunked "
            "records through the ring",
        )

    def _collect_params(self, store) -> dict:
        p = super()._collect_params(store)
        p["transport"] = "native"
        p["ring_bytes"] = store.get("btl_native_ring_bytes")
        return p
