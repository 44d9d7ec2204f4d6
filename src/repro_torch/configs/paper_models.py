"""The paper's experiment models (counterpart of
``repro.configs.paper_models``). Only VGG11-CIFAR is ported so far."""
from repro_torch.models.cnn import CNNConfig


def vgg11_cifar(n_classes: int = 10) -> CNNConfig:
    return CNNConfig(name=f"vgg11-c{n_classes}", arch="vgg11",
                     n_classes=n_classes, in_channels=3, img_size=32)


MODELS = {"vgg11-cifar": vgg11_cifar}
