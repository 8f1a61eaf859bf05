"""Model zoo, registry-keyed by the reference's model names.

Importing this package registers ResNet18 and ResNet50 (classification).
"""

from medseg_tpu_torch.core.registry import get_model  # noqa: F401
from medseg_tpu_torch.models import resnet  # noqa: F401
from medseg_tpu_torch.models.resnet import ResNetClassifier  # noqa: F401
