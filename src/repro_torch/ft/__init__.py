"""Fault tolerance: the atomic-publish checkpoint protocol
(`checkpoint.py`), shared by the durability checkpoints and the
tensor-state `save`/`restore`."""
