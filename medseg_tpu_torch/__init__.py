"""medseg_tpu_torch: the PyTorch + CUDA port of medseg_tpu for NVIDIA Hopper.

The package mirrors medseg_tpu's layout (core/, data/, native/, ops/, nn/,
models/, interop/, eval/, infer/, train/, apps/, utils/) so each module's
counterpart is easy to find; inside it uses PyTorch idiom.  It imports
torch, numpy, cv2, PIL and the standard library, never jax, flax, pandas,
sklearn or anything of the JAX package.  Public functions keep the JAX
package's NHWC layout.

Entry points (BatchLoader, the model factories) run on the card unless the
caller passes device="cpu"; without a card they raise.  Every hand-written
kernel (ops/kernels/) launches for CUDA tensors and uses its plain PyTorch
version only for CPU tensors.

Ported so far: data ingestion (the stratified split, packing with the
native C++ loader or cv2), the fused aug+infer path, the eval harness and
its parity report, the fused stem, the classification and segmentation
trainers and the CLIP/CLIPSeg finetuners, the inference cascade (Pipeline,
server, batch predict, the web demo), the whole ten-model zoo, CLIP and
CLIPSeg included, and the CLI over all of it (ROADMAP.md, queue A).
"""

__version__ = "0.1.0"
