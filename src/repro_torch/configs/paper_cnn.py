"""The paper's own model family: small conv classifier for the KAKURENBO
reproduction on synthetic classification (a copy of
``repro/configs/paper_cnn.py::CONFIG``)."""
from repro_torch.models.cnn import CNNConfig

CONFIG = CNNConfig(name="paper-cifar-cnn", image_size=16, widths=(32, 64),
                   num_classes=10, hidden=128)
