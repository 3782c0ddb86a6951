"""Multi-device and multi-process builds: the mesh on torch.distributed
(mesh.py, shard.py) and the file-coordinated build (distributed.py)."""
