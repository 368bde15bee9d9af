"""Placement of rows across partitions (the counterpart of
``presto_tpu/parallel``). Only the value hash that spill partitioning
shares with the exchange is ported so far."""
