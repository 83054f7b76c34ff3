"""Multi-device execution: one process per device over ``torch.distributed``
(``parallel/mesh.py``)."""
