"""Multi-device scaling over `torch.distributed` (port of
splslam_tpu/parallel): `mesh` (the mesh, batch sharding, batched
tracking and the local launcher) and `gba_sharded` (edge-sharded global
BA)."""
