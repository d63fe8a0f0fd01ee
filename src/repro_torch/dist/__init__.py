"""Multi-device plumbing on ``torch.distributed`` (port of ``repro.dist``,
serving part): ``mesh`` lays the ranks of a process group out as a (data,
model) mesh, ``tp`` marks and slices the quantized projections for tensor
parallelism and holds the collectives the model code calls."""
