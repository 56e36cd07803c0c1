"""The paper's experiments on the port (``python -m repro_torch.experiments.table2``)."""
