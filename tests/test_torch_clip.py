"""The port's CLIP slice module by module against the JAX package on the
CPU: the jax.image.resize matrices, the bicubic uint8 grid, clip_preprocess,
the ViT blocks and towers, CLIP, CLIPSeg, the weight converters, the prompt
ids, the text features and the tokenizer.  Models run at the tiny tower
configs of tests/test_interop.py:_tower_cfgs on the same seeded numpy
inputs; the full-width models are checked by their state-dict keys."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu import interop as jinterop
from medseg_tpu.infer.pipeline import Pipeline as JPipeline
from medseg_tpu.interop import clip_tokenizer as jtok
from medseg_tpu.models.clip import CLIPModule as JCLIPModule
from medseg_tpu.models.clipseg import CLIPSegModel as JCLIPSegModel
from medseg_tpu.nn import vit as jvit
from medseg_tpu.ops.clip_prep import clip_preprocess as jclip_preprocess
from medseg_tpu_torch.infer.pipeline import Pipeline
from medseg_tpu_torch.interop import clip_tokenizer as ttok
from medseg_tpu_torch.interop import from_jax as FJ
from medseg_tpu_torch.interop import prompts as P
from medseg_tpu_torch.interop import text_features as TF
from medseg_tpu_torch.models.clip import CLIPClassifier, CLIPModule, init_weights
from medseg_tpu_torch.models.clipseg import CLIPSegModel
from medseg_tpu_torch.nn import vit
from medseg_tpu_torch.ops import image as I
from medseg_tpu_torch.ops.clip_prep import clip_preprocess
from tests import torch_clip_helpers as H

torch.set_num_threads(1)

CPU = torch.device("cpu")
# Port float32 against JAX float32 on the tiny models: float32 noise (the
# two sum in other orders).  Measured against a float64 run of the port:
# CLIP's logits (|max| 3.3) lie within 1.2e-6 (JAX) and 1.4e-6 (the port's
# float32) of it, its image and text features (|max| 2.4, 3.6) within
# 8.4e-7 and 5.4e-7, CLIPSeg's logits (|max| 0.45) within 3.5e-7.  1e-5 of
# max(1, |out|max) is 12x the farthest pair of those.
TOL = 1e-5

# ---------------------------------------------------------------- resize

RESIZES = [("bicubic", n_out, n_in) for n_out, n_in in
           [(224, 256), (352, 256), (22, 14), (224, 299), (352, 299), (224, 384),
            (352, 384), (224, 512), (352, 512), (224, 1024), (352, 1024)]]
RESIZES += [("bilinear", 256, 352)]


@pytest.mark.parametrize("method,n_out,n_in", RESIZES)
def test_resize_matrix_matches_jax_image_resize(method, n_out, n_in):
    """Every resize the JAX package's CLIP path makes: clip_prep's 256 ->
    224/352, the serving grids from 299, 384, 512 and 1024, the position
    grid 14 -> 22 and the harness's bilinear 352 -> 256.  The matrix is
    jax.image.resize of an identity, within 1e-6 (float32 rounding of
    JAX's own weights; 7.1e-7 the farthest seen)."""
    want = np.asarray(jax.image.resize(jnp.eye(n_in), (n_out, n_in), method))
    got = I._jax_resize_matrix(n_out, n_in, method)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the taps hold every non-zero of the matrix, and the contraction is it
    idx, w = I._resize_taps(n_out, n_in, method, CPU)
    dense = np.zeros((n_out, n_in), np.float32)
    np.add.at(dense, (np.arange(n_out)[None, :].repeat(idx.shape[0], 0), idx.numpy()),
              w.numpy())
    np.testing.assert_array_equal(dense, got)


@pytest.mark.parametrize("shape,size", [((299, 299), 224), ((384, 512), 352),
                                        ((200, 180), 224)])
def test_bicubic_grid_matches_jax_except_ties(shape, size):
    """Pipeline._to_grid's bicubic uint8 grid against the JAX package's:
    equal except where JAX's float value lies within 1e-3 of a rounding
    tie (the sums round differently in the last bit), and there off by 1."""
    img = np.random.default_rng(3).integers(0, 256, (1, *shape, 3), np.uint8)
    got = Pipeline._to_grid(img, size, CPU, "bicubic").numpy().astype(int)
    want = np.asarray(JPipeline._to_grid(jnp.asarray(img), size, "bicubic")).astype(int)
    raw = np.asarray(jax.image.resize(jnp.asarray(img, jnp.float32),
                                      (1, size, size, 3), "bicubic"))
    differ = got != want
    assert np.abs(got - want).max() <= 1
    assert (np.abs(raw[differ] - np.floor(raw[differ]) - 0.5) < 1e-3).all()
    assert differ.mean() < 1e-3


@pytest.mark.parametrize("src,size", [(256, 224), (256, 352), (224, 224)])
def test_clip_preprocess_matches_jax(src, size):
    """256 -> 224 and 256 -> 352 (the harness's float resize: within 1e-5,
    the einsum's other summation order, 5.3e-6 the farthest seen), and a
    batch already at its grid (the serving path: B2's plain version),
    equal to the JAX function's eager value bit for bit (inside jit XLA
    turns the division into a reciprocal multiply, 2.4e-7 away)."""
    x = np.random.default_rng(4).integers(0, 256, (3, src, src, 3), np.uint8)
    got = clip_preprocess(torch.from_numpy(x), size).numpy()
    want = np.asarray(jclip_preprocess(jnp.asarray(x), size))
    assert got.shape == want.shape == (3, size, size, 3) and got.dtype == np.float32
    if src == size:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- blocks

def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))


def _encoder_layer_sd(p, prefix=""):
    sd = {}
    FJ._encoder_layer(sd, "x", p)
    return {prefix + k[2:]: v for k, v in sd.items()}


def test_attention_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 40)).astype(np.float32)
    jm = jvit.Attention(40, 2)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    m = vit.Attention(40, 2)
    sd = {}
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        FJ._dense(sd, proj, jax.tree_util.tree_map(np.asarray, v["params"][proj]))
    m.load_state_dict(sd, strict=True)
    causal = jnp.triu(jnp.full((7, 7), -jnp.inf), k=1)[None, None]
    with torch.no_grad():
        for is_causal, mask in ((False, None), (True, causal)):
            _close(m(torch.from_numpy(x), is_causal), jm.apply(v, jnp.asarray(x), mask))


@pytest.mark.parametrize("post_norm", [False, True])
def test_encoder_layer_matches_jax(post_norm):
    """Pre-norm quick-gelu (the towers) and post-norm relu (CLIPSeg's decoder)."""
    cfg = dict(hidden_size=40, num_layers=1, num_heads=2, intermediate_size=80,
               hidden_act="relu" if post_norm else "quick_gelu")
    x = np.random.default_rng(6).standard_normal((2, 9, 40)).astype(np.float32)
    jm = jvit.EncoderLayer(jvit.TowerConfig(**cfg), post_norm=post_norm)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(1), jnp.asarray(x)))
    m = vit.EncoderLayer(vit.TowerConfig(**cfg), post_norm=post_norm)
    m.load_state_dict(_encoder_layer_sd(v["params"]), strict=True)
    with torch.no_grad():
        _close(m(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


def _vision_tower(variables):
    m = vit.VisionTower(H.TV)
    sd = {}
    FJ._vision_tower(sd, "v", variables["params"]["vision"])
    m.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    return m


def test_vision_tower_with_interpolated_grid_matches_jax():
    """48px at patch 8: the 4x4 native positions resampled to 6x6
    bicubically; the pooled output and every hidden state."""
    variables = H.clip_variables()
    x = np.random.default_rng(7).standard_normal((2, 48, 48, 3)).astype(np.float32)
    jtower = jvit.VisionTower(H.JV)
    want_pooled, want_hidden = jtower.apply({"params": variables["params"]["vision"]},
                                            jnp.asarray(x))
    with torch.no_grad():
        pooled, hidden = _vision_tower(variables)(torch.from_numpy(x))
    _close(pooled, want_pooled)
    assert len(hidden) == len(want_hidden) == 3
    for got, want in zip(hidden, want_hidden):
        _close(got, want)
    # the interpolated positions alone
    native = variables["params"]["vision"]["position_embedding"]
    want = jtower.apply({"params": variables["params"]["vision"]}, jnp.asarray(native), 6,
                        method=jvit.VisionTower.interpolated_positions)
    with torch.no_grad():
        got = _vision_tower(variables).embeddings.positions(6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_text_tower_pools_at_the_first_eos():
    """The row [98, 9, 99, 97] pools at position 2, and [98, 99, 5, 99] at
    1: the first eos, as JAX's argmax picks."""
    variables = H.clip_variables()
    ids = np.array([[98, 9, 99, 97], [98, 99, 5, 99], [98, 5, 7, 99]], np.int32)
    want = jvit.TextTower(H.JT).apply({"params": variables["params"]["text"]},
                                      jnp.asarray(ids))
    m = vit.TextTower(H.TT)
    sd = {}
    FJ._text_tower(sd, "t", variables["params"]["text"])
    m.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        _close(m(torch.from_numpy(ids)), want)


# ---------------------------------------------------------------- models

def _clip_module():
    m = CLIPModule(H.TV, H.TT, H.PROJ)
    m.load_state_dict(FJ.clip_state_dict(H.clip_variables()), strict=True)
    return m.eval()


def test_clip_module_towers_and_logits_match_jax():
    variables = H.clip_variables()
    jm = H.JTinyCLIP()
    x = np.random.default_rng(8).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = np.asarray(H.PROMPT_IDS["clip"], np.int32)
    m = _clip_module()
    with torch.no_grad():
        _close(m.encode_image(torch.from_numpy(x)),
               jm.apply(variables, jnp.asarray(x), method=JCLIPModule.encode_image))
        _close(m.encode_text(torch.from_numpy(ids)),
               jm.apply(variables, jnp.asarray(ids), method=JCLIPModule.encode_text))
        _close(m(torch.from_numpy(x), torch.from_numpy(ids)),
               jm.apply(variables, jnp.asarray(x), jnp.asarray(ids)))


def test_clip_classifier_logits_match_jax():
    """The classifier's state dict drawn from the full one equals
    from_jax's of the classifier's variables, and its float32 logits
    against the same normalized text features match JAX's."""
    full = FJ.clip_state_dict(H.clip_variables())
    p = H.clip_variables()["params"]
    cls_vars = {"params": {k: p[k] for k in ("vision", "visual_projection", "logit_scale")}}
    sd = TF.classifier_state_dict(full)
    ref = FJ.clip_classifier_state_dict(cls_vars)
    assert sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k]) for k in sd)
    m = CLIPClassifier(H.TV, H.PROJ)
    m.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    tf = rng.standard_normal((3, H.PROJ)).astype(np.float32)
    tf /= np.linalg.norm(tf, axis=-1, keepdims=True)
    want = H.JTinyClassifier().apply(cls_vars, jnp.asarray(x), jnp.asarray(tf))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x), torch.from_numpy(tf))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("conditioning", ["cond", "input_ids"])
def test_clipseg_forward_matches_jax(conditioning):
    """At 48px (interpolated positions), FiLM-conditioned by a [1, 24]
    embedding broadcast over B=2, or by token ids through the text tower."""
    variables = H.clipseg_variables()
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 48, 48, 3)).astype(np.float32)
    ids = np.asarray(H.PROMPT_IDS["clipseg"], np.int32)
    cond = rng.standard_normal((1, H.PROJ)).astype(np.float32)
    kw = ({"cond": cond} if conditioning == "cond" else {"input_ids": ids})
    want = H.JTinyCLIPSeg().apply(variables, jnp.asarray(x),
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
    m = CLIPSegModel(H.TV, H.TT, H.PROJ, **H.SEG)
    m.load_state_dict(FJ.clipseg_state_dict(variables), strict=True)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == (2, 24, 24) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("name", ["CLIP", "CLIPSeg"])
def test_full_width_keys_match_from_jax_of_eval_shape(name):
    """The full-size models' state-dict keys are from_jax's of the JAX
    model's jax.eval_shape(init), and that state dict loads with strict=True
    (shapes included): CLIP ViT-B/32 at 224 with the 49408-token text
    tower, CLIPSeg rd64-refined at 352."""
    if name == "CLIP":
        jm, size, ids = JCLIPModule(), 224, jnp.zeros((3, 8), jnp.int32)
        convert, port = FJ.clip_state_dict, CLIPModule
    else:
        jm, size, ids = JCLIPSegModel(), 352, jnp.zeros((1, 8), jnp.int32)
        convert, port = FJ.clipseg_state_dict, CLIPSegModel
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, size, size, 3)), ids)
    sd = convert(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    with torch.device("meta"):
        model = port()
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd, strict=True, assign=True)
    assert sum(t.numel() for t in sd.values()) > 1.4e8


def test_hf_state_dicts_load_strictly():
    """A tiny HF CLIPModel and CLIPSegForImageSegmentation state dict (the
    reference's checkpoint format; with older releases' position_ids
    buffers, which hf_state_dict drops) loads into the port with
    strict=True, and the port's logits and segmentation logits match
    HF's."""
    pytest.importorskip("transformers")
    from transformers import CLIPModel as HFCLIPModel
    from transformers import CLIPSegForImageSegmentation

    from tests.test_interop import _tiny_clip_config

    torch.manual_seed(0)
    hf = HFCLIPModel(_tiny_clip_config()).eval()
    m = CLIPModule(H.TV, H.TT, H.PROJ)
    # older transformers releases saved the position_ids buffers too
    sd = dict(hf.state_dict(), **{f"{t}_model.embeddings.position_ids":
                                  torch.arange(n)[None] for t, n in (("text", 16),
                                                                     ("vision", 17))})
    m.load_state_dict(TF.hf_state_dict(sd), strict=True)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = np.array([[98, 5, 7, 99], [98, 9, 99, 97]], np.int64)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids),
                  pixel_values=torch.from_numpy(x).permute(0, 3, 1, 2)).logits_per_image
        _close(m.eval()(torch.from_numpy(x), torch.from_numpy(ids)), want)

    seg = CLIPSegForImageSegmentation(_tiny_clipseg_config()).eval()
    ms = CLIPSegModel(H.TV, H.TT, H.PROJ, extract_layers=(0, 1), reduce_dim=16,
                      decoder_heads=2, decoder_intermediate=32)
    ms.load_state_dict(TF.hf_state_dict(seg.state_dict()), strict=True)
    with torch.no_grad():
        want = seg(input_ids=torch.from_numpy(ids[:1]),
                   pixel_values=torch.from_numpy(x[:1]).permute(0, 3, 1, 2)).logits
        _close(ms.eval()(torch.from_numpy(x[:1]), torch.from_numpy(ids[:1])), want)


def _tiny_clipseg_config():
    from transformers import CLIPSegConfig, CLIPSegTextConfig, CLIPSegVisionConfig

    return CLIPSegConfig.from_text_vision_configs(
        CLIPSegTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=2, max_position_embeddings=16,
                          vocab_size=100, projection_dim=24, eos_token_id=99,
                          bos_token_id=98, pad_token_id=97),
        CLIPSegVisionConfig(hidden_size=40, intermediate_size=80, num_hidden_layers=2,
                            num_attention_heads=2, image_size=32, patch_size=8,
                            projection_dim=24),
        projection_dim=24, reduce_dim=16, extract_layers=[0, 1],
        decoder_num_attention_heads=2, decoder_intermediate_size=32,
        use_complex_transposed_convolution=True)


def test_init_weights_is_flax_distributed():
    torch.manual_seed(0)
    m = init_weights(CLIPModule(H.TV, H.TT, H.PROJ), torch.Generator().manual_seed(1))
    emb = m.vision_model.embeddings
    for t in (emb.class_embedding, emb.position_embedding.weight,
              m.text_model.embeddings.token_embedding.weight):
        assert abs(t.std().item() - 0.02) < 0.005
    assert m.logit_scale.item() == pytest.approx(2.6592)
    ln = m.vision_model.pre_layrnorm
    assert torch.equal(ln.weight, torch.ones(40)) and torch.equal(ln.bias, torch.zeros(40))
    fc1 = m.vision_model.encoder.layers[0].mlp.fc1
    assert torch.equal(fc1.bias, torch.zeros(80))
    assert abs(fc1.weight.std().item() - (1 / 40) ** 0.5) < 0.02
    assert fc1.weight.abs().max().item() <= 2 * (1 / 40) ** 0.5 / 0.8796 + 1e-6


# ------------------------------------------------------- prompts, features

def test_prompt_ids_from_the_bundle(tmp_path, monkeypatch):
    """$MEDSEG_PROMPT_IDS first, with the JAX package's schema and prompt
    check; without a bundle or a vocabulary, PromptIdsUnavailable."""
    monkeypatch.setenv("MEDSEG_PROMPT_IDS", str(H.write_prompt_ids(tmp_path / "ids.json")))
    ids = P.get_prompt_token_ids()
    from medseg_tpu.interop import prompts as JP

    want = JP.get_prompt_token_ids()
    for k in ("clip", "clipseg"):
        np.testing.assert_array_equal(ids[k], want[k])
    (tmp_path / "bad.json").write_text(json.dumps({"prompts": ["x"], **H.PROMPT_IDS}))
    monkeypatch.setenv("MEDSEG_PROMPT_IDS", str(tmp_path / "bad.json"))
    with pytest.raises(P.PromptIdsUnavailable, match="different prompts"):
        P.get_prompt_token_ids()
    monkeypatch.delenv("MEDSEG_PROMPT_IDS")
    monkeypatch.setenv("MEDSEG_CLIP_VOCAB", str(tmp_path / "no_vocab_here"))
    if not P.BUNDLED_IDS_PATH.exists():
        with pytest.raises(P.PromptIdsUnavailable, match="unavailable offline"):
            P.get_prompt_token_ids()


def test_text_features_and_cond_match_jax(tmp_path):
    """The normalized prompt features and CLIPSeg's conditional embedding
    from each checkpoint's own text tower, against the JAX package's on the
    same weights and ids."""
    ids = H.PROMPT_IDS
    with H.tiny_clip_patched(tmp_path):
        full = FJ.clip_state_dict(H.clip_variables())
        cls_sd, tf = TF.clip_bundle_from_torch_sd(full, device="cpu")
        want = jinterop.clip_text_features(jinterop.convert_clip(full, num_layers=2),
                                          np.asarray(ids["clip"]))
        _close(tf, want)
        np.testing.assert_allclose(tf.norm(dim=-1).numpy(), 1.0, rtol=1e-6)
        assert cls_sd.keys() == TF.classifier_state_dict(full).keys()
        seg_sd = FJ.clipseg_state_dict(H.clipseg_variables())
        _, cond = TF.clipseg_bundle_from_torch_sd(seg_sd, device="cpu")
        want = jinterop.clipseg_cond(jinterop.convert_clipseg(seg_sd, num_layers=2,
                                                              extract_depth=2),
                                     np.asarray(ids["clipseg"]))
        assert cond.shape == (1, H.PROJ)
        _close(cond, want)


# ---------------------------------------------------------------- tokenizer

def _tiny_vocab(path, merges=()):
    units = list(jtok._bytes_to_unicode().values())
    vocab = units + [u + "</w>" for u in units] + ["".join(m) for m in merges]
    vocab += [jtok.SOT, jtok.EOT]
    path.mkdir()
    (path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m)
                                                                   for m in merges))
    return str(path)


def test_tokenizer_matches_jax_on_a_synthetic_vocabulary(tmp_path):
    """The port's BPE against the JAX package's on byte units and a few
    merges: the same ids for the four default prompts, padded to the
    longest as HF's padding=True."""
    vocab = _tiny_vocab(tmp_path / "v", merges=(("c", "h"), ("ch", "e"), ("l", "u"),
                                                ("lu", "n"), ("s", "t"), ("e", "s</w>")))
    ours, theirs = ttok.ClipTokenizer(vocab), jtok.ClipTokenizer(vocab)
    texts = list(P.ALL_PROMPTS)
    got, want = ours(texts), theirs(texts)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert ours.encode("lungs") == [ours.encoder[t] for t in ("lun", "g", "s</w>")]


def test_tokenizer_matches_transformers_with_real_tables():
    """Exact ids against transformers' CLIPTokenizer where the real
    vocabulary is on disk; skipped without it, as tests/test_clip_tokenizer.py."""
    if ttok._find_cached_vocab() is None and not __import__("os").environ.get(
            "MEDSEG_CLIP_VOCAB"):
        pytest.skip("no CLIP BPE vocabulary on disk")
    transformers = pytest.importorskip("transformers")
    ref = transformers.CLIPTokenizer.from_pretrained("openai/clip-vit-base-patch32",
                                                     local_files_only=True)
    texts = list(P.ALL_PROMPTS)
    want = np.asarray(ref(texts, padding=True)["input_ids"], np.int32)
    np.testing.assert_array_equal(ttok.ClipTokenizer()(texts), want)
