"""Multi-device plumbing on ``torch.distributed`` (port of ``repro.dist``):
``mesh`` lays the ranks of a process group out as a (data, model) mesh,
``tp`` marks and slices the quantized projections for tensor parallelism
and holds the collectives the model code calls, ``sharding`` and
``partitioning`` hold the logical-axis rules, the models' constraint
points and each leaf's spec, ``straggler`` flags hosts whose steps run
slow."""
