"""Training (port of ``repro.train``): ``step`` builds the train step
(loss, gradients, clipping, AdamW, the QAT projection), ``loop`` is the
fault-tolerant supervisor with the deployed-model evaluation."""
