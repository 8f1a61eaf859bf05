"""Model zoo, registry-keyed by the reference's model names.

Importing this package registers ResNet18 and ResNet50 (classification)
and ResNetUnet (segmentation).
"""

from medseg_tpu_torch.core.registry import get_model  # noqa: F401
from medseg_tpu_torch.models import resnet, resnet_unet  # noqa: F401
from medseg_tpu_torch.models.resnet import ResNetClassifier  # noqa: F401
from medseg_tpu_torch.models.resnet_unet import ResNetUnet  # noqa: F401
