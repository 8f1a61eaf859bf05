"""Model zoo, registry-keyed by the reference's model names.

Importing this package registers ResNet18, ResNet50, VGG16 and VGG19
(classification) and ResNetUnet, AttentionUNet, R2Unet and R2AttUnet
(segmentation).
"""

from medseg_tpu_torch.core.registry import get_model  # noqa: F401
from medseg_tpu_torch.models import (attention_unet, r2u_net, resnet,  # noqa: F401
                                     resnet_unet, vgg)
from medseg_tpu_torch.models.attention_unet import AttentionUNet  # noqa: F401
from medseg_tpu_torch.models.r2u_net import R2UNet  # noqa: F401
from medseg_tpu_torch.models.resnet import ResNetClassifier  # noqa: F401
from medseg_tpu_torch.models.resnet_unet import ResNetUnet  # noqa: F401
from medseg_tpu_torch.models.vgg import VGGClassifier  # noqa: F401
