"""Training (port of ``repro.train``): ``step`` builds the train step
(loss, gradients, clipping, AdamW, the QAT projection), ``fsdp`` the same
step with parameters and moments sharded over a process group, ``loop``
is the fault-tolerant supervisor with the deployed-model evaluation."""
