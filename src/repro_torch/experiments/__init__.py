"""The paper's experiments on the port (``python -m repro_torch.experiments.table2``):
Tables 2, 3, 5 and 6 and Figs. 2 and 4, one module each."""
