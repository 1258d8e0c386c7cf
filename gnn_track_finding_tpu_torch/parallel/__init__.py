"""Multi-device execution over `torch.distributed` process groups: the
edge-partitioned schedule (edge_shard), the ("data", "edge") mesh
(mesh) and the multi-host entry points (multihost)."""
