"""Resource definitions.

Behavioral parity with the reference's resource model
(cruise-control/src/main/java/.../common/Resource.java:19-26): four balanced
resources — CPU, network inbound, network outbound, disk — each with a
host/broker scope flag and a comparison epsilon.  The reference derives its
epsilons from a stress-test finding that float summation over ~800k replicas
drifts by >0.1% (Resource.java:28-31); we keep the same guard because the
tensor model sums f32 loads with segment-sums at the same scale.

In the tensor model the resource axis is always axis ``-1`` of load arrays in
this fixed id order, so ``Resource.CPU.id == 0`` indexes column 0 of
``f32[R, 4]`` replica loads.
"""

from __future__ import annotations

import enum


class Resource(enum.IntEnum):
    """Balanced resource kinds; the int value is the tensor column index."""

    CPU = 0
    NW_IN = 1
    NW_OUT = 2
    DISK = 3

    @property
    def resource_name(self) -> str:
        return _NAMES[self]

    @property
    def is_host_resource(self) -> bool:
        # CPU and both network directions are host-level (shared across
        # brokers co-located on a host); disk is broker-level only.
        return self in (Resource.CPU, Resource.NW_IN, Resource.NW_OUT)

    @property
    def is_broker_resource(self) -> bool:
        return self in (Resource.CPU, Resource.DISK)

    @property
    def epsilon(self) -> float:
        return _EPSILONS[self]

    @classmethod
    def cached_values(cls) -> tuple["Resource", ...]:
        return _CACHED

    def epsilon_for(self, util1: float, util2: float) -> float:
        """Scale-aware epsilon: max(abs epsilon, EPSILON_PERCENT * total).

        Mirrors the reference's Resource.epsilon(double, double) which guards
        float-sum drift proportionally to the compared magnitudes.
        """
        return max(self.epsilon, EPSILON_PERCENT * (util1 + util2))


_NAMES = {
    Resource.CPU: "cpu",
    Resource.NW_IN: "networkInbound",
    Resource.NW_OUT: "networkOutbound",
    Resource.DISK: "disk",
}

# Absolute comparison units per resource (CPU is in [0, 100] percent-ish
# units; NW in KB/s; DISK in MB) — same magnitudes as the reference.
_EPSILONS = {
    Resource.CPU: 0.001,
    Resource.NW_IN: 10.0,
    Resource.NW_OUT: 10.0,
    Resource.DISK: 100.0,
}

EPSILON_PERCENT = 0.0008

_CACHED = tuple(Resource)

NUM_RESOURCES = len(_CACHED)

HOST_RESOURCES = tuple(r for r in _CACHED if r.is_host_resource)
BROKER_RESOURCES = tuple(r for r in _CACHED if r.is_broker_resource)
