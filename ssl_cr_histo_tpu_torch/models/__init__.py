"""Model zoo: torchvision-shaped ResNet backbones and the SSL_CR_Histo
heads."""

from ssl_cr_histo_tpu_torch.models.nets import Classifier, FinetuneHead, TripletNet, feature_dim  # noqa: F401
from ssl_cr_histo_tpu_torch.models.resnet import ResNet, ResNet18, ResNet50  # noqa: F401
