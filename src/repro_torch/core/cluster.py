"""Clusters-of-clusters topology and 2-level kernel addressing (paper §4).

The paper scales Galapagos past its 256-kernel limit by building clusters of
clusters: kernel addresses become (cluster_id, local_id), all inter-cluster
messages go through each cluster's Gateway kernel (local_id 0), and each FPGA
stores 2N-1 routes instead of N^2.  This module keeps that bookkeeping: the
Cluster Builder assigns kernel IDs out of it, tests assert the paper's
routing-table arithmetic, and the launcher maps clusters onto mesh axes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MAX_KERNELS_PER_CLUSTER = 256  # Galapagos hard limit (paper §4)
MAX_CLUSTERS = 256
GATEWAY_LOCAL_ID = 0

KernelId = Tuple[int, int]  # (cluster_id, local_id)


@dataclass
class Kernel:
    cluster_id: int
    local_id: int
    kind: str  # "gateway" | "compute" | "gmi" | "virtual"
    op: str = ""  # e.g. "linear_quant", "softmax", "broadcast", "scatter"
    meta: Dict = field(default_factory=dict)

    @property
    def kid(self) -> KernelId:
        return (self.cluster_id, self.local_id)

    @property
    def global_id(self) -> int:
        return self.cluster_id * MAX_KERNELS_PER_CLUSTER + self.local_id


@dataclass
class Cluster:
    cluster_id: int
    kernels: List[Kernel] = field(default_factory=list)

    def add(self, kind: str, op: str = "", **meta) -> Kernel:
        local_id = len(self.kernels)
        if local_id >= MAX_KERNELS_PER_CLUSTER:
            raise ValueError(
                f"cluster {self.cluster_id} exceeds the "
                f"{MAX_KERNELS_PER_CLUSTER}-kernel Galapagos limit; "
                f"split across more clusters (paper §4)")
        k = Kernel(self.cluster_id, local_id, kind, op, dict(meta))
        self.kernels.append(k)
        return k

    @property
    def gateway(self) -> Kernel:
        return self.kernels[GATEWAY_LOCAL_ID]


@dataclass
class ClusterTopology:
    clusters: List[Cluster] = field(default_factory=list)
    edges: List[Tuple[KernelId, KernelId]] = field(default_factory=list)

    def new_cluster(self) -> Cluster:
        if len(self.clusters) >= MAX_CLUSTERS:
            raise ValueError(f"exceeds {MAX_CLUSTERS}-cluster limit (§4)")
        c = Cluster(len(self.clusters))
        # kernel 0 of every cluster is the Gateway (paper's restriction)
        c.add("gateway", "gateway")
        self.clusters.append(c)
        return c

    def connect(self, src: Kernel, dst: Kernel) -> None:
        """Intra-cluster edges are direct; inter-cluster edges MUST route
        via the destination cluster's gateway (paper §4)."""
        if src.cluster_id != dst.cluster_id and dst.kind != "gateway":
            gw = self.clusters[dst.cluster_id].gateway
            self.edges.append((src.kid, gw.kid))
            self.edges.append((gw.kid, dst.kid))
        else:
            self.edges.append((src.kid, dst.kid))

    # -- the paper's routing-table arithmetic --------------------------------

    def routing_entries_per_device(self) -> int:
        """2N-1 with gateways (N = clusters): N-1 gateway routes + N kernels
        in own cluster (paper §4)."""
        n = len(self.clusters)
        k = max((len(c.kernels) for c in self.clusters), default=0)
        return k + (n - 1)

    def routing_entries_flat(self) -> int:
        """N^2-style entries if any kernel could address any other directly."""
        return sum(len(c.kernels) for c in self.clusters)

    @property
    def total_kernels(self) -> int:
        return sum(len(c.kernels) for c in self.clusters)

    def validate(self) -> None:
        assert len(self.clusters) <= MAX_CLUSTERS
        for c in self.clusters:
            assert len(c.kernels) <= MAX_KERNELS_PER_CLUSTER
            assert c.kernels[GATEWAY_LOCAL_ID].kind == "gateway"
            ids = [k.local_id for k in c.kernels]
            assert ids == list(range(len(ids))), "kernel IDs must be contiguous"
        for (sc, sl), (dc, dl) in self.edges:
            if sc != dc:
                assert dl == GATEWAY_LOCAL_ID or sl == GATEWAY_LOCAL_ID, (
                    "inter-cluster edge bypasses the gateway")


def max_addressable_kernels() -> int:
    return MAX_CLUSTERS * MAX_KERNELS_PER_CLUSTER  # 65536 (paper §4)
