"""The sharded back-end solvers of the PyTorch port (mirrors
plvio_tpu/parallel): the shard mesh, the landmark-sharded window BAs
`dist_liba` / `dist_ba`, the chain-partitioned `chain_ba` / `chain_liba`
and the multi-process bootstrap."""
