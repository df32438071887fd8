"""Model zoo: torchvision-shaped ResNet backbones, UNI2-h's ViT and the
SSL_CR_Histo heads."""

from ssl_cr_histo_tpu_torch.models.nets import (  # noqa: F401
    MODEL_NAMES, Classifier, FinetuneHead, TripletNet, feature_dim)
from ssl_cr_histo_tpu_torch.models.resnet import ResNet, ResNet18, ResNet50  # noqa: F401
from ssl_cr_histo_tpu_torch.models.vit import ViT  # noqa: F401
