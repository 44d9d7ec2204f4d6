"""The paper's experiment models (counterpart of
``repro.configs.paper_models``): MLP-(500, 500), LeNet-300-100 and LeNet5 on
MNIST-shaped images, AlexNet-CIFAR (FC 2048), VGG11-CIFAR (FC 512) and
ResNet18 on CIFAR-shaped ones (synthetic stand-ins: the environment is
offline)."""
from repro_torch.models.cnn import CNNConfig


def mlp_mnist(hidden=(500, 500)) -> CNNConfig:
    return CNNConfig(name="mlp-mnist", arch="mlp", n_classes=10,
                     in_channels=1, img_size=28, hidden=tuple(hidden))


def lenet300100() -> CNNConfig:
    return CNNConfig(name="lenet300100", arch="lenet300100", n_classes=10,
                     in_channels=1, img_size=28, hidden=(300, 100))


def lenet5() -> CNNConfig:
    return CNNConfig(name="lenet5", arch="lenet5", n_classes=10,
                     in_channels=1, img_size=28)


def alexnet_cifar(n_classes: int = 10) -> CNNConfig:
    return CNNConfig(name=f"alexnet-c{n_classes}", arch="alexnet",
                     n_classes=n_classes, in_channels=3, img_size=32)


def vgg11_cifar(n_classes: int = 10) -> CNNConfig:
    return CNNConfig(name=f"vgg11-c{n_classes}", arch="vgg11",
                     n_classes=n_classes, in_channels=3, img_size=32)


def resnet18_cifar(n_classes: int = 10) -> CNNConfig:
    return CNNConfig(name=f"resnet18-c{n_classes}", arch="resnet18",
                     n_classes=n_classes, in_channels=3, img_size=32)


# the training CLI's --model names (Table 1's row names but for the
# CIFAR models, which keep the names of the earlier CLI)
MODELS = {"mlp-mnist": mlp_mnist, "lenet300100": lenet300100,
          "lenet5": lenet5, "alexnet-cifar": alexnet_cifar,
          "vgg11-cifar": vgg11_cifar, "resnet18-cifar": resnet18_cifar}
