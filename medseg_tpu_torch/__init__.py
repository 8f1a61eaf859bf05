"""medseg_tpu_torch: the PyTorch + CUDA port of medseg_tpu for NVIDIA Hopper.

The package mirrors medseg_tpu's layout (core/, data/, ops/, nn/, models/,
interop/, eval/) so each module's counterpart is easy to find; inside it uses
PyTorch idiom.  It imports torch and numpy only, never jax, flax or anything
of the JAX package.  Public functions keep the JAX package's NHWC layout.

Entry points (BatchLoader, the model factories) run on the card unless the
caller passes device="cpu"; without a card they raise.  Every hand-written
kernel (ops/kernels/) launches for CUDA tensors and uses its plain PyTorch
version only for CPU tensors.

Ported so far: the fused aug+infer path, the eval harness, the fused stem,
the classification and segmentation trainers, the inference cascade
(Pipeline, server, batch predict) and the whole ten-model zoo, CLIP and
CLIPSeg included (ROADMAP.md, queue A).
"""

__version__ = "0.1.0"
