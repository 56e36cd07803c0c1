"""Batched serving example on the PyTorch port: prefill + decode on any
registry arch (the counterpart of ``examples/serve_demo.py``).

    PYTHONPATH=src python examples/torch_serve_demo.py --arch mamba2-130m
    PYTHONPATH=src python examples/torch_serve_demo.py --device cpu --layers 2

On the card by default, decoding through one captured CUDA graph a step
(``launch/serve.py::capture_decode``; ``--device cpu`` runs the kernels'
plain versions and decodes eagerly); ``--full`` serves the published
widths, ``--layers`` cuts the depth.
"""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
