"""The paper's own experimental model (§V-A): McMahan-style CNN [33].

conv(32,5x5) -> pool -> conv(64,5x5) -> pool -> fc(512) -> fc(classes).
V = 5 trainable layers, so cutting point v ∈ {1,2,3,4}.

This is the model used by the CNN-scale federated simulator
(repro.core.simulator) for the paper's Figs. 3-8; the LLM zoo is configured
separately via ModelConfig.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-cnn"
    image_size: int = 28
    channels: int = 1
    conv_channels: Tuple[int, ...] = (32, 64)
    kernel_size: int = 5
    fc_dim: int = 512
    num_classes: int = 10

    @property
    def num_layers(self) -> int:
        # conv1, conv2, fc1, fc2 + output -> V=5 per the paper's v in {1..4}
        return len(self.conv_channels) + 3


CONFIG = CNNConfig()
CIFAR_CONFIG = CNNConfig(name="paper-cnn-cifar", image_size=32, channels=3)

# Light variant for the 2-core CPU container: same V=5 structure and the
# same relative behaviour across schemes/cuts, ~30x fewer FLOPs. The
# benchmarks use this by default (scaling noted in EXPERIMENTS.md).
LIGHT_CONFIG = CNNConfig(name="paper-cnn-light", conv_channels=(8, 16), fc_dim=128)
LIGHT_CIFAR_CONFIG = CNNConfig(name="paper-cnn-light-cifar", image_size=32,
                               channels=3, conv_channels=(8, 16), fc_dim=128)
