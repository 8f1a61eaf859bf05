"""The port's data parallelism against the JAX package's on a 2-device mesh.

Two gloo processes on the CPU (tests/torch_dist_worker.py, spawned once for
the module) run the port at W=2 on their rows of each global batch; the
JAX package runs the same global batch on a 2-device mesh of conftest's 8
virtual CPU devices, with the same weights carried across by
interop/from_jax and the same inputs drawn from numpy seeds; and this
process runs the port at W=1 on the global batch.  Also the sharding
helpers, the loader's rows and the global draws, against JAX's or against
one process, without spawning.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.data.loader import BatchLoader as JLoader
from medseg_tpu.data.synthetic import synthetic_cls as jsynthetic_cls
from medseg_tpu.data.synthetic import synthetic_seg as jsynthetic_seg
from medseg_tpu.eval import harness as JH
from medseg_tpu.models import resnet as jresnet
from medseg_tpu.nn.blocks import ConvBN as JConvBN
from medseg_tpu.parallel import data_parallel_mesh as jmesh_of
from medseg_tpu.parallel import pad_to_multiple as jpad_to_multiple
from medseg_tpu.parallel import replicated as jreplicated
from medseg_tpu.parallel import require_divisible_batch as jrequire_divisible_batch
from medseg_tpu.parallel import shard_batch as jshard_batch
from medseg_tpu.parallel.spmd import make_cls_train_step_explicit as jexplicit
from medseg_tpu.train import steps as JS
from medseg_tpu.train.freeze import all_trainable as jall_trainable
from medseg_tpu_torch.core.config import AugmentConfig
from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.data.synthetic import synthetic_cls
from medseg_tpu_torch.interop import from_jax as FJ
from medseg_tpu_torch.nn.blocks import dropout
from medseg_tpu_torch.ops.augment import sample_augment_params
from medseg_tpu_torch.parallel import (DataParallelGroup, all_reduce_sum, data_parallel,
                                       dist, initialize_from_env, pad_to_multiple,
                                       require_divisible_batch, shard_batch)
from tests import torch_dist_worker as W
from tests.test_torch_resnet import _random_leaf, flax_resnet
from tests.torch_zoo_helpers import flax_variables, state_dict

torch.set_num_threads(1)

LR = 1e-5  # torch_dist_worker.cls_steps
STEPS = 2


def jmesh():
    return jmesh_of(jax.devices()[:2])


def fake_group(rank: int, size: int) -> DataParallelGroup:
    """A group of `size` ranks that never calls a collective: what the
    loader and the draws read (rank, size)."""
    return DataParallelGroup(object(), rank, size, "cpu")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --- the JAX side -------------------------------------------------------------

def _flax_random(model, *inputs, seed=0):
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), *inputs))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _random_leaf(rng, p, s.shape).astype(np.float32), shapes)


class JTinyMLP(fnn.Module):
    """tests/test_spmd.py's TinyMLP."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = x.reshape(x.shape[0], -1)
        x = fnn.relu(fnn.Dense(32)(x))
        return fnn.Dense(3)(x)


class JTinyNet(fnn.Module):
    """tests/dist_case.py's TinyNet."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = JConvBN(8, kernel=3, stride=2)(x, train)
        return fnn.Dense(3)(x.mean(axis=(1, 2)))


def _conv_bn_sd(sd, prefix, p, s):
    FJ._conv(sd, f"{prefix}0", p["conv"])
    FJ._bn(sd, f"{prefix}1", p["bn"], s["bn"])


def _explicit_sd(name, v):
    sd = {}
    if name == "convbn":
        _conv_bn_sd(sd, "ConvBN_0.", v["params"]["ConvBN_0"], v["batch_stats"]["ConvBN_0"])
    for dense in ("Dense_0", "Dense_1"):
        if dense in v["params"]:
            FJ._dense(sd, dense, v["params"][dense])
    return sd


def jax_bn(variables, dtype):
    """flax ConvBN(8) in training on the 2-device mesh: y, the input and
    parameter gradients of sum(y * ct), and the new batch statistics."""
    x, ct = W.bn_inputs()
    model = JConvBN(8, dtype=dtype)
    mesh = jmesh()

    cast = functools.partial(jax.tree.map, lambda a: jnp.asarray(a, dtype))

    def f(params, x, ct):
        y, mut = model.apply({"params": params, "batch_stats": cast(variables["batch_stats"])},
                             x, train=True, mutable=["batch_stats"])
        return (y * ct).sum(), (y, mut["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(
        cast(variables["params"]), jshard_batch(np.asarray(x, dtype), mesh),
        jshard_batch(np.asarray(ct, dtype), mesh))
    return jax.device_get((y, gx, gp, stats))


def jax_cls_run(variables):
    """STEPS steps of make_cls_train_step over the mesh from `variables`:
    the losses and the final state."""
    mesh = jmesh()
    model = jresnet.resnet18(dropout=0.0)
    opt = JS.build_optimizer(LR, 5e-4, 1.0, jall_trainable(variables["params"]))
    step = JS.make_cls_train_step(model, opt, 0.1, prep=None)
    state = jax.device_put(JS.init_state(model, jax.tree.map(jnp.asarray, variables), opt),
                           jreplicated(mesh))
    step_losses = []
    for i in range(STEPS):
        x, y = W.cls_batch(i)
        state, loss, _ = step(state, jshard_batch(x, mesh), jshard_batch(y, mesh),
                              jax.random.key(0))
        step_losses.append(float(loss))
    return step_losses, jax.device_get(state)


def jax_explicit(name, variables):
    mesh = jmesh()
    model = JTinyMLP() if name == "mlp" else JTinyNet()
    opt = JS.build_optimizer(1e-2, 1e-4, 1.0, jall_trainable(variables["params"]))
    state = jax.device_put(JS.init_state(model, jax.tree.map(jnp.asarray, variables), opt),
                           jreplicated(mesh))
    x, y = W.small_batch()
    state, loss, correct = jexplicit(model, opt, mesh)(
        state, jshard_batch(x, mesh), jshard_batch(y, mesh), jax.random.key(42))
    return float(loss), int(correct), jax.device_get(state)


def jax_eval(name, variables):
    seg = name != "ResNet18"
    ds = (jsynthetic_seg if seg else jsynthetic_cls)(n=13, img_size=W.IMG)
    return JH.evaluate_model(name, JLoader(ds, 8, shuffle=False), variables,
                             log=lambda *_: None, mesh=jmesh())


# --- one module-wide spawn ------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Weights written, the two ranks spawned, and while they run the JAX
    package's results and the port's at W=1 computed here."""
    work = tmp_path_factory.mktemp("dp")
    jv = {"bn": _flax_random(JConvBN(8), jnp.zeros((1, 8, 8, 3)), seed=3),
          "cls": flax_resnet(18)[1],
          "mlp": _flax_random(JTinyMLP(), jnp.zeros((1, 8, 8, 3)), seed=4),
          "convbn": _flax_random(JTinyNet(), jnp.zeros((1, 8, 8, 3)), seed=5),
          "ResNet18": flax_resnet(18)[1],
          "AttentionUNet": flax_variables("AttentionUNet")}
    sd = {"cls": FJ.resnet_classifier_state_dict(jv["cls"], 18),
          "ResNet18": FJ.resnet_classifier_state_dict(jv["ResNet18"], 18),
          "AttentionUNet": state_dict("AttentionUNet", jv["AttentionUNet"]),
          "mlp": _explicit_sd("mlp", jv["mlp"]), "convbn": _explicit_sd("convbn", jv["convbn"])}
    sd["bn"] = {}
    _conv_bn_sd(sd["bn"], "", jv["bn"]["params"], jv["bn"]["batch_stats"])
    for name, d in sd.items():
        torch.save(d, work / f"{name}.weights.pt")

    cases = ["collectives", "bn", "cls", "explicit", "eval"]
    with W.spawn_ranks(work, cases) as collect:
        with jax.enable_x64(True):
            jbn = {"f64": jax_bn(jv["bn"], jnp.float64)}
        jbn["f32"] = jax_bn(jv["bn"], jnp.float32)
        jax_res = {"bn": jbn, "cls": jax_cls_run(jv["cls"]),
                   "explicit": {n: jax_explicit(n, jv[n]) for n in ("mlp", "convbn")},
                   "eval": {n: jax_eval(n, jv[n]) for n in ("ResNet18", "AttentionUNet")}}
        one = {"cls": W.case_cls(W.WORLD1, work),
               "cls_plain_f64": W.cls_steps(W.WORLD1, work, torch.float64, use_group=False),
               "eval": W.case_eval(W.WORLD1, work)}
        ranks = collect()
    return {"jv": jv, "ranks": ranks, "jax": jax_res, "one": one}


# --- helpers, without spawning --------------------------------------------------

@pytest.mark.parametrize("n,multiple", [(8, 2), (13, 2), (5, 8), (1, 3)])
def test_pad_to_multiple_matches_jax(n, multiple):
    a = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)
    got, got_n = pad_to_multiple(a, multiple)
    want, want_n = jpad_to_multiple(a, multiple)
    assert got_n == want_n and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [2, 3])
def test_require_divisible_batch_matches_jax(size):
    """The same check and the same message, "device" meaning a rank."""
    mesh = jmesh_of(jax.devices()[:size])
    group = fake_group(0, size)
    ds = synthetic_cls(n=8, img_size=8)
    ok = BatchLoader(ds, 6, shuffle=False, device="cpu")
    require_divisible_batch(group, ok, None)
    jrequire_divisible_batch(mesh, JLoader(jsynthetic_cls(n=8, img_size=8), 6,
                                           shuffle=False))
    bad = BatchLoader(ds, 7, shuffle=False, device="cpu")
    with pytest.raises(ValueError) as got:
        require_divisible_batch(group, ok, bad)
    with pytest.raises(ValueError) as want:
        jrequire_divisible_batch(mesh, JLoader(jsynthetic_cls(n=8, img_size=8), 7,
                                               shuffle=False))
    assert str(got.value) == str(want.value)


def test_initialize_from_env_without_the_variables_is_a_noop():
    """As tests/test_distributed.py:97; `auto` (TPU-pod autodetection)
    raises and names the explicit variables."""
    assert initialize_from_env(env={}) is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="MEDSEG_NUM_PROCESSES"):
        initialize_from_env(env={"MEDSEG_COORDINATOR": "auto"})


def test_world1_group_and_collectives_without_a_process_group():
    g = dist.global_data_parallel_mesh("cpu")
    assert (g.rank, g.size, g.joined, g.device.type) == (0, 1, False, "cpu")
    x = torch.arange(4.0)
    assert all_reduce_sum(x, g) is x and g.all_gather(x) == [x]
    assert torch.equal(dist.shard_process_local(x.numpy(), g), x)
    with pytest.raises(ValueError, match="process group"):
        DataParallelGroup(None, 0, 2, "cpu")


@pytest.mark.parametrize("pad", [False, True])
def test_loader_yields_each_ranks_rows_of_the_global_batch(pad):
    """Two ranks' batches, concatenated, are one process's padded global
    batches; train batches drop the ragged tail, validation pads it to the
    group's size; real_counts() are each rank's real rows."""
    ds = synthetic_cls(n=13, img_size=8)

    def loader(group):
        return BatchLoader(ds, 4, shuffle=True, seed=3, device="cpu", drop_last=not pad,
                           pad_to_multiple=2 if pad else None, group=group)

    plain = [b[0] for b in loader(None)]
    ranks = [[b[0] for b in loader(fake_group(r, 2))] for r in range(2)]
    assert len(plain) == (4 if pad else 3)
    for i, whole in enumerate(plain):
        assert torch.equal(torch.cat([ranks[0][i], ranks[1][i]]), whole)
    counts = [loader(fake_group(r, 2)).real_counts() for r in range(2)]
    assert [a + b for a, b in zip(*counts)] == loader(None).global_real_counts()
    if pad:  # 13 = 4+4+4+1: the last batch is 1 real row and a pad row
        assert counts == [[2, 2, 2, 1], [2, 2, 2, 0]]
        assert torch.equal(ranks[1][-1], ranks[0][-1])  # the pad repeats the last row
    with pytest.raises(ValueError, match="does not split"):
        list(BatchLoader(ds, 4, shuffle=False, device="cpu", group=fake_group(0, 2)))


def test_shard_batch_keeps_each_ranks_rows():
    x = np.arange(12).reshape(6, 2)
    parts = [shard_batch(x, fake_group(r, 3)) for r in range(3)]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    assert parts[1].tolist() == [[4, 5], [6, 7]]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x, fake_group(0, 4))


def test_draws_are_the_global_batchs():
    """The augmentation's parameters and the dropout mask at W=2, each
    rank from its own copy of one seeded generator, are one process's draws
    for the global batch: W ranks draw what one process draws."""
    cfg = AugmentConfig()
    whole = sample_augment_params(torch.Generator().manual_seed(7), 6, cfg)
    x = torch.ones(6, 5)
    mask = dropout(x, 0.5, torch.Generator().manual_seed(8))
    for r in range(2):
        with data_parallel(fake_group(r, 2)):
            part = sample_augment_params(torch.Generator().manual_seed(7), 3, cfg)
            part_mask = dropout(x[:3], 0.5, torch.Generator().manual_seed(8))
        for a, b in zip(part, whole):
            assert torch.equal(a, b[3 * r:3 * r + 3])
        assert torch.equal(part_mask, mask[3 * r:3 * r + 3])


# --- W=2 against the JAX mesh and against W=1 -------------------------------------

def test_replicate_and_process_local_rows(run):
    """Two ranks: replicate_ leaves rank 0's weights on both (they were
    drawn from each rank's own seed), shard_process_local keeps each
    rank's rows and, when the ranks pass 2 and 3 rows, raises on both (so
    neither waits in a later collective), and all_gather returns every
    rank's tensor in rank order."""
    r0, r1 = run["ranks"]["collectives"]
    assert all(torch.equal(v, r1["state"][k]) for k, v in r0["state"].items())
    torch.manual_seed(1)
    own = W.conv_bn(torch.float32).state_dict()
    assert not torch.equal(own["0.weight"], r1["state"]["0.weight"])
    assert r0["rows"].tolist() == [[0, 0]] * 3 and r1["rows"].tolist() == [[1, 1]] * 3
    assert "different row counts" in r0["raised"] and "different row counts" in r1["raised"]
    for r in (r0, r1):
        assert r["gathered"].tolist() == [[0, 10], [1, 11]]


def _cat(ranks, tag, key):
    return np.concatenate([r[tag][key] for r in ranks])


@pytest.mark.parametrize("tag,tol", [("f64", 1e-10), ("f32", 2e-5)])
def test_batchnorm_matches_flax_on_a_mesh(run, tag, tol):
    """A train-mode ConvBN at W=2 (global statistics over the ranks'
    rows) against flax's on the 2-device mesh: the output and the input
    gradient row for row, the weight gradients (summed over the ranks'
    shares), the new running statistics; relative to each tensor's largest
    value (the gradients to the largest parameter gradient: the conv bias
    feeding the BatchNorm has an exactly zero one, rounding noise), within
    1e-10 in float64 and 2e-5 in float32 (the statistics' fast variance,
    E[x^2] - E[x]^2, of inputs with mean 0.5 and std 2)."""
    ranks = run["ranks"]["bn"]
    y, gx, gp, stats = run["jax"]["bn"][tag]
    assert rel(_cat(ranks, tag, "y"), y) < tol
    assert rel(_cat(ranks, tag, "dx"), gx) < tol
    want = {}
    _conv_bn_sd(want, "", gp, {"bn": {"mean": np.zeros(8), "var": np.zeros(8)}})
    gmax = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for k in ("0.weight", "0.bias", "1.weight", "1.bias"):
        diff = np.abs(sum(r[tag][f"grad/{k}"] for r in ranks) - want[k].numpy()).max()
        assert diff < tol * gmax, (k, diff / gmax)
    got = {}
    _conv_bn_sd(got, "", run["jv"]["bn"]["params"], stats)
    for k in ("1.running_mean", "1.running_var"):
        for r in ranks:
            assert rel(r[tag][f"buffer/{k}"], got[k].numpy()) < tol, k


def _port_names(variables):
    return {k: v.numpy() for k, v in FJ.resnet_classifier_state_dict(variables, 18).items()
            if not k.endswith("num_batches_tracked")}


def _params_close(got: dict, want: dict, steps: int):
    """The parameters after `steps` AdamW steps at LR: all but 1 in 10^4
    elements within 1e-6 + 2% of steps*LR, none off by more than 2*steps*LR
    (AdamW moves an element whose gradient is float32 noise by ~LR either
    way, tests/test_torch_train.py)."""
    n_off = n_all = 0
    for k, v in got.items():
        diff = np.abs(np.asarray(v, np.float64) - want[k])
        assert diff.max() <= 2 * steps * LR, (k, diff.max())
        n_off += int((diff > 1e-6 + 0.02 * steps * LR).sum())
        n_all += diff.size
    assert n_off <= 1e-4 * n_all, (n_off, n_all)


def test_cls_step_matches_jax_on_a_mesh(run):
    """ResNet18 at 32px, a global batch of 8 (4 a rank), 2 stage-2 steps
    (the clip fires) in float32 against make_cls_train_step jitted over the
    2-device mesh: each step's loss within 1e-4 relative on both ranks,
    the parameters as _params_close, the running statistics within 1e-4."""
    losses, state = run["jax"]["cls"]
    want = _port_names({"params": state.params, "batch_stats": state.batch_stats})
    for r in run["ranks"]["cls"]:
        np.testing.assert_allclose(r["f32"]["loss"], losses, rtol=1e-4)
        _params_close({k[6:]: v.numpy() for k, v in r["f32"].items()
                       if k.startswith("param/")}, want, STEPS)
        for k, v in r["f32"].items():
            if k.startswith("buffer/"):
                np.testing.assert_allclose(v.numpy(), want[k[7:]], rtol=1e-4, atol=1e-4,
                                           err_msg=k)


@pytest.mark.parametrize("tag", ["f64", "f32"])
def test_cls_step_matches_one_process(run, tag):
    """The same 2 steps at W=2 against the port at W=1 on the global
    batch: in float64 the losses, the correct counts, step 1's clipped
    gradients and every parameter and running statistic within 1e-9 of
    the tensor's largest value (the ranks bit for bit alike); in float32
    the losses within 1e-5, the gradients within 1e-4 of their largest,
    the parameters as _params_close.  And at W=1, the data-parallel step
    (global-statistics BatchNorm) against the plain one in float64, 1e-9."""
    one = run["one"]["cls"][tag]
    r0, r1 = (r[tag] for r in run["ranks"]["cls"])
    assert r0["loss"] == r1["loss"] and r0["correct"] == r1["correct"] == one["correct"]
    tol = 1e-9 if tag == "f64" else 1e-4
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-9 if tag == "f64" else 1e-5)
    gmax = max(g.abs().max().item() for g in one["grads"].values())
    for k, g in one["grads"].items():
        np.testing.assert_allclose(r0["grads"][k].numpy(), g.numpy(), rtol=0,
                                   atol=tol * gmax, err_msg=k)
    keys = [k for k in one if k.startswith(("param/", "buffer/"))]
    for k in keys:
        assert torch.equal(r0[k], r1[k]), k
    if tag == "f64":
        for k in keys:
            assert rel(r0[k].numpy(), one[k].numpy()) < 1e-9, k
        plain = run["one"]["cls_plain_f64"]
        np.testing.assert_allclose(plain["loss"], one["loss"], rtol=1e-9)
        for k in keys:
            assert rel(plain[k].numpy(), one[k].numpy()) < 1e-9, k
    else:
        _params_close({k: r0[k].numpy() for k in keys if k.startswith("param/")},
                      {k: one[k].numpy().astype(np.float64) for k in keys}, STEPS)


@pytest.mark.parametrize("name", ["mlp", "convbn"])
def test_explicit_step_matches_jax(run, name):
    """make_cls_train_step_explicit at W=2 against parallel/spmd.py's on
    the mesh (per-rank BatchNorm, one all-reduce of the gradients, the loss
    and the running statistics, the correct count summed): the loss within
    1e-5, the correct count equal, the parameters and running statistics
    after the step within 1e-5 (lr 1e-2: AdamW's first step moves each
    element by about lr, so float32 noise cannot flip one), but for the
    conv bias feeding TinyNet's BatchNorm: its gradient is exactly zero,
    rounding noise that AdamW turns into a step of up to lr either way, so
    it is held within 2*lr of its initial value."""
    loss, correct, state = run["jax"]["explicit"][name]
    want = _explicit_sd(name, {"params": state.params,
                               "batch_stats": getattr(state, "batch_stats", None) or {}})
    for r in run["ranks"]["explicit"]:
        got = r[name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert got["correct"] == correct
        init = _explicit_sd(name, run["jv"][name])
        for k, v in want.items():
            if k == "ConvBN_0.0.bias":
                assert np.abs(got[f"param/{k}"].numpy() - init[k].numpy()).max() <= 2e-2
            elif not k.endswith("num_batches_tracked"):
                kind = "buffer" if "running" in k else "param"
                np.testing.assert_allclose(got[f"{kind}/{k}"].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["ResNet18", "AttentionUNet"])
def test_sharded_eval_matches_jax_and_one_process(run, name):
    """evaluate_model(mesh=) at W=2 over 13 samples in batches of 8 (a
    ragged tail of 5: 3 rows and 2 + a pad row) against the JAX harness on
    the mesh and the port at W=1: every metric within rel 1e-4, as
    tests/test_sharded_eval.py; both ranks report the same metrics, and
    the caller's loader comes back untouched (checked in each rank)."""
    want = run["jax"]["eval"][name]
    one = run["one"]["eval"][name]
    r0, r1 = (r[name] for r in run["ranks"]["eval"])
    for k, v in want.items():
        for got in (r0, r1, one):
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(v, np.float64), rtol=1e-4, err_msg=k)
        np.testing.assert_array_equal(r0[k], r1[k])
