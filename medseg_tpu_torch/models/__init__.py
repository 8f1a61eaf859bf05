"""Model zoo, registry-keyed by the reference's model names.

Importing this package registers ResNet18, ResNet50, VGG16, VGG19 and CLIP
(classification) and ResNetUnet, AttentionUNet, R2Unet, R2AttUnet and
CLIPSeg (segmentation).
"""

from medseg_tpu_torch.core.registry import get_model  # noqa: F401
from medseg_tpu_torch.models import (attention_unet, clip, clipseg, r2u_net,  # noqa: F401
                                     resnet, resnet_unet, vgg)
from medseg_tpu_torch.models.attention_unet import AttentionUNet  # noqa: F401
from medseg_tpu_torch.models.clip import CLIPClassifier, CLIPModule  # noqa: F401
from medseg_tpu_torch.models.clipseg import CLIPSegModel  # noqa: F401
from medseg_tpu_torch.models.r2u_net import R2UNet  # noqa: F401
from medseg_tpu_torch.models.resnet import ResNetClassifier  # noqa: F401
from medseg_tpu_torch.models.resnet_unet import ResNetUnet  # noqa: F401
from medseg_tpu_torch.models.vgg import VGGClassifier  # noqa: F401
