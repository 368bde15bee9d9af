"""Placement of rows across partitions and mesh slots (the counterpart of
``presto_tpu/parallel``): the mesh of device slots (``mesh.py``) and the
value hash and collectives of the exchange (``exchange.py``)."""
