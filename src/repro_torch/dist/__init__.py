"""Multi-device plumbing on ``torch.distributed`` (port of ``repro.dist``,
serving part and the straggler monitor): ``mesh`` lays the ranks of a
process group out as a (data, model) mesh, ``tp`` marks and slices the
quantized projections for tensor parallelism and holds the collectives
the model code calls, ``straggler`` flags hosts whose steps run slow."""
