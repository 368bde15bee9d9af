"""File formats of the port: ORC and Parquet readers and writers
(counterparts of ``presto_tpu/formats``; reference presto-orc/,
presto-parquet/)."""
