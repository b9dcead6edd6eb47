"""The paper's own evaluation workload: a 3-layer CNN for object detection on
laparoscopic frames (GLENDA [19]), kernels (channels) {32, 64, 128}, 500 samples,
97% reference accuracy.  This is the paper-faithful baseline model for the
STIGMA overlay experiments (Figures 3a/3b)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class CNNConfig:
    name: str = "stigma-cnn"
    image_size: int = 64          # downscaled GLENDA-like frames
    in_channels: int = 3
    channels: tuple = (32, 64, 128)   # paper: "kernel size in the range {32,64,128}"
    n_classes: int = 2            # endometriosis present / absent
    n_samples: int = 500          # paper: "limited to 500 samples"
    reference_accuracy: float = 0.97


STIGMA_CNN = CNNConfig()
