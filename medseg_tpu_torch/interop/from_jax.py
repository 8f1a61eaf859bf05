"""Carry weights across: JAX-package flax variables -> the port's state dicts.

The variables are the nested dicts that flax's `init`/checkpoints hold
(numpy arrays, or any array type numpy can read).  Layout changes:
- conv kernel HWIO -> OIHW;
- ConvTranspose kernel [kh,kw,Ci,Co] -> [Ci,Co,kh,kw] with both spatial
  axes flipped first: flax writes out[2i+dy, 2j+dx] = x[i,j] @ W[1-dy,1-dx]
  (tests/test_upt.py), torch uses W[dy,dx];
- Dense kernel [in, out] -> Linear weight [out, in];
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  (plus num_batches_tracked = 0);
- LayerNorm scale/bias -> weight/bias;
- the ViT towers' names -> HF's (clip_state_dict, clipseg_state_dict).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from medseg_tpu_torch.models.vgg import VGG16_STAGES, VGG19_STAGES, _vgg_feature_indices

_STAGES = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3)}


def _tensor(a, transpose=None) -> torch.Tensor:
    a = np.asarray(a)
    if transpose is not None:
        a = a.transpose(transpose)
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _conv(sd: Dict[str, torch.Tensor], name: str, p: Mapping):
    sd[f"{name}.weight"] = _tensor(p["kernel"], (3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _tensor(p["bias"])


def _conv_transpose(sd: Dict[str, torch.Tensor], name: str, p: Mapping):
    sd[f"{name}.weight"] = _tensor(np.asarray(p["kernel"])[::-1, ::-1], (2, 3, 0, 1))
    sd[f"{name}.bias"] = _tensor(p["bias"])


def _bn(sd: Dict[str, torch.Tensor], name: str, p: Mapping, s: Mapping):
    sd[f"{name}.weight"] = _tensor(p["scale"])
    sd[f"{name}.bias"] = _tensor(p["bias"])
    sd[f"{name}.running_mean"] = _tensor(s["mean"])
    sd[f"{name}.running_var"] = _tensor(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _dense(sd: Dict[str, torch.Tensor], name: str, p: Mapping):
    """A Dense with or without bias -> Linear."""
    sd[f"{name}.weight"] = _tensor(p["kernel"], (1, 0))
    if "bias" in p:
        sd[f"{name}.bias"] = _tensor(p["bias"])


def _resnet_trunk(sd: Dict[str, torch.Tensor], p: Mapping, s: Mapping, depth: int,
                  stem=("conv1", "bn1"), stage="layer{}", first_stage=1):
    """The encoder's convs and BatchNorms, under `stem` and the stage names
    stage.format(first_stage + k)."""
    convs = ("conv1", "conv2", "conv3") if depth >= 50 else ("conv1", "conv2")
    _conv(sd, stem[0], p["conv1"])
    _bn(sd, stem[1], p["bn1"], s["bn1"])
    for k, n_blocks in enumerate(_STAGES[depth]):
        for i in range(n_blocks):
            name = f"layer{k + 1}_{i}"
            prefix = f"{stage.format(first_stage + k)}.{i}"
            bp, bs = p[name], s[name]
            for conv in convs:
                bn = conv.replace("conv", "bn")
                _conv(sd, f"{prefix}.{conv}", bp[conv])
                _bn(sd, f"{prefix}.{bn}", bp[bn], bs[bn])
            if "down_conv" in bp:
                _conv(sd, f"{prefix}.downsample.0", bp["down_conv"])
                _bn(sd, f"{prefix}.downsample.1", bp["down_bn"], bs["down_bn"])


def resnet_classifier_state_dict(variables: Mapping, depth: int) -> Dict[str, torch.Tensor]:
    """flax ResNetClassifier variables -> state dict of models.resnet's
    ResNetClassifier (torchvision names, head at fc.1)."""
    sd: Dict[str, torch.Tensor] = {}
    _resnet_trunk(sd, variables["params"]["encoder"],
                  variables["batch_stats"]["encoder"], depth)
    _dense(sd, "fc.1", variables["params"]["head"]["fc"])
    return sd


def vgg_classifier_state_dict(variables: Mapping, depth: int) -> Dict[str, torch.Tensor]:
    """flax VGGClassifier variables -> state dict of models.vgg's
    VGGClassifier (torchvision names: features.{i}, classifier.0/3/7)."""
    stages = {16: VGG16_STAGES, 19: VGG19_STAGES}[depth]
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for stage, pairs in enumerate(_vgg_feature_indices(stages)):
        for i, (conv, bn) in enumerate(pairs):
            _conv(sd, f"features.{conv}", p["features"][f"conv{stage}_{i}"])
            _bn(sd, f"features.{bn}", p["features"][f"bn{stage}_{i}"],
                s["features"][f"bn{stage}_{i}"])
    for name, index in (("fc1", 0), ("fc2", 3), ("head_fc", 7)):
        _dense(sd, f"classifier.{index}", p[name])
    return sd


def _double_conv(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping, s: Mapping):
    """flax DoubleConv (conv1/conv2, each a ConvBN) -> nn.blocks.DoubleConv's
    Sequential indices 0, 1 and 3, 4."""
    for conv, index in (("conv1", 0), ("conv2", 3)):
        _conv(sd, f"{prefix}.{index}", p[conv]["conv"])
        _bn(sd, f"{prefix}.{index + 1}", p[conv]["bn"], s[conv]["bn"])


def resnet_unet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ResNetUnet variables -> state dict of models.resnet_unet's
    ResNetUnet (the reference's ResnetUnet.py names)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _resnet_trunk(sd, p["encoder"], s["encoder"], 50,
                  stem=("encoder1.0", "encoder1.1"), stage="encoder{}", first_stage=2)
    for i in range(5, 1, -1):
        _conv_transpose(sd, f"decoder{i}.up_sample", p[f"decoder{i}"]["up"])
        _double_conv(sd, f"decoder{i}.basic_block", p[f"decoder{i}"]["block"],
                     s[f"decoder{i}"]["block"])
    _conv_transpose(sd, "decoder1.0", p["up1"])
    _conv(sd, "decoder1.1", p["conv1"])
    _bn(sd, "decoder1.2", p["bn1"], s["bn1"])
    _conv(sd, "out", p["out"])
    return sd


def _conv_bn(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping, s: Mapping):
    """flax ConvBN (conv, bn) -> a Sequential's indices 0 and 1."""
    _conv(sd, f"{prefix}.0", p["conv"])
    _bn(sd, f"{prefix}.1", p["bn"], s["bn"])


def _up_conv(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping, s: Mapping):
    """flax UpConv -> nn.blocks.UpConv (`up.1` conv, `up.2` BN)."""
    _conv(sd, f"{prefix}.up.1", p["conv"]["conv"])
    _bn(sd, f"{prefix}.up.2", p["conv"]["bn"], s["conv"]["bn"])


def _attention_gate(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping, s: Mapping):
    """flax AttentionGate (w_g, w_x, psi) -> nn.blocks.AttentionGate
    (W_g, W_x, psi)."""
    for ours, theirs in (("w_g", "W_g"), ("w_x", "W_x"), ("psi", "psi")):
        _conv_bn(sd, f"{prefix}.{theirs}", p[ours], s[ours])


def _rrcnn(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping, s: Mapping):
    """flax RRCNNBlock (conv_1x1, rcnn1, rcnn2) -> nn.blocks.RRCNNBlock
    (conv_1x1, RCNN.0.conv, RCNN.1.conv)."""
    _conv(sd, f"{prefix}.conv_1x1", p["conv_1x1"])
    for i, name in enumerate(("rcnn1", "rcnn2")):
        _conv_bn(sd, f"{prefix}.RCNN.{i}.conv", p[name]["conv"], s[name]["conv"])


def attention_unet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax AttentionUNet variables -> state dict of
    models.attention_unet's AttentionUNet (the reference's names)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(1, 6):
        _double_conv(sd, f"conv{i}", p[f"conv{i}"], s[f"conv{i}"])
    for i in range(5, 1, -1):
        _up_conv(sd, f"up{i}", p[f"up{i}"], s[f"up{i}"])
        _attention_gate(sd, f"att{i}", p[f"att{i}"], s[f"att{i}"])
        _double_conv(sd, f"up_conv{i}", p[f"up_conv{i}"], s[f"up_conv{i}"])
    _conv(sd, "out", p["out"])
    return sd


def r2u_net_state_dict(variables: Mapping, attention: bool) -> Dict[str, torch.Tensor]:
    """flax R2UNet variables -> state dict of models.r2u_net's R2UNet
    (R2Unet, or R2AttUnet with attention=True; the reference's names)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(1, 6):
        _rrcnn(sd, f"RRCNN{i}", p[f"rrcnn{i}"], s[f"rrcnn{i}"])
    for i in range(5, 1, -1):
        _up_conv(sd, f"up{i}", p[f"up{i}"], s[f"up{i}"])
        if attention:
            _attention_gate(sd, f"att{i}", p[f"att{i}"], s[f"att{i}"])
        _rrcnn(sd, f"up_RRCNN{i}", p[f"up_rrcnn{i}"], s[f"up_rrcnn{i}"])
    _conv(sd, "conv_1x1", p["out"])
    return sd


def _layer_norm(sd: Dict[str, torch.Tensor], name: str, p: Mapping):
    sd[f"{name}.weight"] = _tensor(p["scale"])
    sd[f"{name}.bias"] = _tensor(p["bias"])


def _n_layers(p: Mapping) -> int:
    return sum(1 for k in p if k.startswith("layer") and k[5:].isdigit())


def _encoder_layer(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping):
    """flax EncoderLayer (attn, ln1, ln2, mlp) -> HF's names."""
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _dense(sd, f"{prefix}.self_attn.{proj}", p["attn"][proj])
    _layer_norm(sd, f"{prefix}.layer_norm1", p["ln1"])
    _layer_norm(sd, f"{prefix}.layer_norm2", p["ln2"])
    _dense(sd, f"{prefix}.mlp.fc1", p["mlp"]["fc1"])
    _dense(sd, f"{prefix}.mlp.fc2", p["mlp"]["fc2"])


def _vision_tower(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping):
    emb = f"{prefix}.embeddings"
    _conv(sd, f"{emb}.patch_embedding", p["patch_embed"])
    sd[f"{emb}.class_embedding"] = _tensor(p["class_embedding"])
    sd[f"{emb}.position_embedding.weight"] = _tensor(p["position_embedding"])
    _layer_norm(sd, f"{prefix}.pre_layrnorm", p["pre_layernorm"])  # HF's spelling
    for i in range(_n_layers(p)):
        _encoder_layer(sd, f"{prefix}.encoder.layers.{i}", p[f"layer{i}"])
    _layer_norm(sd, f"{prefix}.post_layernorm", p["post_layernorm"])


def _text_tower(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping):
    sd[f"{prefix}.embeddings.token_embedding.weight"] = _tensor(p["token_embedding"])
    sd[f"{prefix}.embeddings.position_embedding.weight"] = _tensor(p["position_embedding"])
    for i in range(_n_layers(p)):
        _encoder_layer(sd, f"{prefix}.encoder.layers.{i}", p[f"layer{i}"])
    _layer_norm(sd, f"{prefix}.final_layer_norm", p["final_layernorm"])


def _clip(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping, text: bool = True):
    _vision_tower(sd, f"{prefix}vision_model", p["vision"])
    _dense(sd, f"{prefix}visual_projection", p["visual_projection"])
    if text:
        _text_tower(sd, f"{prefix}text_model", p["text"])
        _dense(sd, f"{prefix}text_projection", p["text_projection"])
    sd[f"{prefix}logit_scale"] = _tensor(p["logit_scale"])


def clip_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax CLIPModule variables -> HF CLIPModel state dict (models.clip's
    CLIPModule)."""
    sd: Dict[str, torch.Tensor] = {}
    _clip(sd, "", variables["params"])
    return sd


def clip_classifier_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax CLIPClassifier variables -> models.clip's CLIPClassifier state
    dict (the vision tower, visual_projection and logit_scale)."""
    sd: Dict[str, torch.Tensor] = {}
    _clip(sd, "", variables["params"], text=False)
    return sd


def clipseg_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax CLIPSegModel variables -> HF CLIPSegForImageSegmentation state
    dict (models.clipseg's CLIPSegModel).

    flax creates a submodule's parameters when it is first called, and
    CLIPSegModel never calls its visual_projection: variables from its
    `init` have none, and HF's key gets zeros here (no CLIPSeg forward
    reads it)."""
    p = dict(variables["params"])
    dec = p["decoder"]
    if "visual_projection" not in p:
        hidden = np.shape(p["vision"]["class_embedding"])[0]
        projection_dim = np.shape(dec["film_mul"]["kernel"])[0]
        p["visual_projection"] = {"kernel": np.zeros((hidden, projection_dim), np.float32)}
    sd: Dict[str, torch.Tensor] = {}
    _clip(sd, "clip.", p)
    _dense(sd, "decoder.film_mul", dec["film_mul"])
    _dense(sd, "decoder.film_add", dec["film_add"])
    _conv(sd, "decoder.transposed_convolution.0", dec["head_conv"])
    _conv_transpose(sd, "decoder.transposed_convolution.2", dec["head_up1"])
    _conv_transpose(sd, "decoder.transposed_convolution.4", dec["head_up2"])
    for i in range(_n_layers(dec)):
        _dense(sd, f"decoder.reduces.{i}", dec[f"reduce{i}"])
        _encoder_layer(sd, f"decoder.layers.{i}", dec[f"layer{i}"])
    return sd
