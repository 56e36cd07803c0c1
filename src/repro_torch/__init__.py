"""PyTorch/CUDA port of the KAKURENBO reproduction (``repro`` is the JAX
reference).  Imports torch and numpy only; the CUDA kernels build at first
use, never at import."""
