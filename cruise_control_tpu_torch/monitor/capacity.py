"""Broker capacity resolution.

Parity with the ``BrokerCapacityConfigResolver`` SPI and its JSON file
implementation (config/BrokerCapacityConfigResolver.java:17,
BrokerCapacityConfigFileResolver.java:149, BrokerCapacityInfo.java): per-
broker capacity for CPU (cores → percent), network in/out (KB/s) and disk
(MB, per logdir for JBOD), with a ``-1`` broker id carrying the default.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource

DEFAULT_CAPACITY_BROKER_ID = -1


@dataclasses.dataclass(frozen=True)
class BrokerCapacityInfo:
    """Capacity of one broker (config/BrokerCapacityInfo.java)."""

    cpu: float                 # total percent (100 × cores)
    network_in: float          # KB/s
    network_out: float         # KB/s
    disk: float                # MB total
    disk_by_logdir: Tuple[Tuple[str, float], ...] = ()
    num_cores: int = 1
    is_estimated: bool = False
    estimation_info: str = ""

    def as_row(self) -> np.ndarray:
        row = np.zeros(NUM_RESOURCES, np.float32)
        row[Resource.CPU] = self.cpu
        row[Resource.NW_IN] = self.network_in
        row[Resource.NW_OUT] = self.network_out
        row[Resource.DISK] = self.disk
        return row


class BrokerCapacityResolver:
    """SPI: resolve a broker's capacity (BrokerCapacityConfigResolver)."""

    def capacity_for_broker(self, rack: str, host: str, broker_id: int,
                            allow_estimation: bool = True) -> BrokerCapacityInfo:
        raise NotImplementedError


class FileCapacityResolver(BrokerCapacityResolver):
    """JSON file resolver (BrokerCapacityConfigFileResolver.java:149).

    Accepts the reference's ``capacityJBOD.json`` shape::

        {"brokerCapacities": [
            {"brokerId": "-1", "capacity": {"DISK": {"/logdir1": "100000", ...}
                                            | "100000",
                                            "CPU": "100" | {"num.cores": "8"},
                                            "NW_IN": "10000", "NW_OUT": "10000"}}]}
    """

    def __init__(self, path: Optional[str] = None, doc: Optional[dict] = None):
        if doc is None:
            with open(path) as f:
                doc = json.load(f)
        self._by_broker: Dict[int, BrokerCapacityInfo] = {}
        for entry in doc.get("brokerCapacities", []):
            broker_id = int(entry["brokerId"])
            self._by_broker[broker_id] = self._parse(entry["capacity"])
        if DEFAULT_CAPACITY_BROKER_ID not in self._by_broker:
            raise ValueError("capacity config must define default brokerId -1")

    @staticmethod
    def _parse(cap: dict) -> BrokerCapacityInfo:
        disk_raw = cap["DISK"]
        if isinstance(disk_raw, dict):
            by_logdir = tuple((ld, float(v)) for ld, v in disk_raw.items())
            disk = float(sum(v for _, v in by_logdir))
        else:
            by_logdir = ()
            disk = float(disk_raw)
        cpu_raw = cap["CPU"]
        if isinstance(cpu_raw, dict):
            cores = int(cpu_raw.get("num.cores", 1))
            cpu = 100.0 * cores
        else:
            cores = max(int(float(cpu_raw) // 100), 1)
            cpu = float(cpu_raw)
        return BrokerCapacityInfo(
            cpu=cpu, network_in=float(cap["NW_IN"]), network_out=float(cap["NW_OUT"]),
            disk=disk, disk_by_logdir=by_logdir, num_cores=cores)

    def capacity_for_broker(self, rack: str, host: str, broker_id: int,
                            allow_estimation: bool = True) -> BrokerCapacityInfo:
        info = self._by_broker.get(broker_id)
        if info is not None:
            return info
        default = self._by_broker[DEFAULT_CAPACITY_BROKER_ID]
        if not allow_estimation:
            raise ValueError(f"no capacity configured for broker {broker_id} "
                             "and estimation disallowed")
        return dataclasses.replace(default, is_estimated=True,
                                   estimation_info=f"default capacity for broker {broker_id}")


class StaticCapacityResolver(BrokerCapacityResolver):
    """Uniform capacity for every broker (tests / synthetic runs)."""

    def __init__(self, cpu: float = 100.0, network_in: float = 200000.0,
                 network_out: float = 200000.0, disk: float = 1000000.0):
        self._info = BrokerCapacityInfo(cpu=cpu, network_in=network_in,
                                        network_out=network_out, disk=disk)

    def capacity_for_broker(self, rack: str, host: str, broker_id: int,
                            allow_estimation: bool = True) -> BrokerCapacityInfo:
        return self._info
