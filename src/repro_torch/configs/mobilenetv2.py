"""MobileNetV2 [arXiv:1801.04381] — the paper's own evaluation network
(W4A4 channel-wise QAT, 8-bit first/last layers; Table 2)."""
from repro_torch.models.mobilenet import MobileNetConfig

ARCH_ID = "mobilenetv2"


def config(quant: str = "qat") -> MobileNetConfig:
    return MobileNetConfig(name=ARCH_ID, width=1.0, resolution=224,
                           n_classes=1000, quant=quant)


def smoke_config(quant: str = "qat") -> MobileNetConfig:
    return MobileNetConfig(name=ARCH_ID + "-smoke", width=0.25, resolution=32,
                           n_classes=10, quant=quant)
