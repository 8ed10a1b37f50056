"""Training the paper's CNNs (VGG11, ResNet18, SegNet) in the port against
`jax.value_and_grad` and the reference's AdamW, on the CPU.

Params come from the JAX package's init through `params_from_numpy`;
batches from the synthetic generators both packages share (numpy from a
seed). Both sides differentiate the float leaves only (VGG11's `None`
pooling slots and ResNet18's `int` block strides are not trained). The
port runs `launch.cnn_train.train_step` on its `ref` oracles and on its
kernel path (`use_backend("cuda")`: the kernel wrappers' plain versions on
CPU tensors under the autograd rules the card runs).

Each of three AdamW steps starts both sides from the JAX trajectory's
params and optimizer state at that step: the step's loss within 1e-6
relative, each gradient leaf and each updated param leaf within 1e-5
relative L2. A free-running trajectory is not compared: AdamW's first
update is lr * sign(g) wherever |g| >> eps, so a gradient element that is
rounding noise around zero (6 in ResNet18's first step on `ref`) takes
opposite signs in the two packages and moves its weight by 2 * lr, which
flips spikes whose membranes sit within 1e-6 of the threshold at the next
step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import SpikingConfig as JSpikingConfig
from repro.models import cnn as jcnn
from repro.optim import adamw as jadamw
from repro_torch.kernels import dispatch
from repro_torch.launch import cnn_train
from repro_torch.models.layers import params_from_numpy
from repro_torch.optim import adamw

torch.set_num_threads(1)
LR = 1e-3
STEPS = 3
B = 2
CASES = [  # (model, img, t_steps, v_th)
    ("segnet", 16, 2, 0.5),
    ("vgg11", 32, 2, 0.5),
    ("resnet18", 32, 2, 0.5),
]


def _rel_l2(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    diff = np.asarray(got, dtype=np.float64) - want
    return float(np.linalg.norm(diff) / (np.linalg.norm(want) + 1e-30))


def _jax_loss(name, jcfg, logits, y):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    if name == "segnet":       # examples/segmentation.py's weighted loss
        w = jnp.where(y == 1, 4.0, 1.0)
        return -jnp.mean(w * jnp.sum(jax.nn.one_hot(y, 2) * logp, axis=-1))
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


@pytest.fixture(scope="module", params=CASES, ids=lambda c: c[0])
def trajectory(request):
    """JAX: STEPS AdamW steps over the float leaves; per step the params
    and optimizer state before it, the loss, the gradients and the params
    after it (numpy)."""
    name, img, t, v_th = request.param
    jcfg = dataclasses.replace(jregistry.paper_cnn_configs()[name], img=img,
                               spiking=JSpikingConfig(t_steps=t,
                                                      lif_vth=v_th))
    tcfg = cnn_train.config(name, t, v_th, img)
    jp = getattr(jcnn, f"{name}_init")(jcfg, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(jp)
    floats = [i for i, leaf in enumerate(leaves) if not isinstance(leaf, int)]

    def tree(fl):
        out = list(leaves)
        for i, f in zip(floats, fl):
            out[i] = f
        return treedef.unflatten(out)

    def loss(fl, x, y):
        logits = getattr(jcnn, f"{name}_apply")(jcfg, tree(fl), x)
        return _jax_loss(name, jcfg, logits, y)

    ocfg = jadamw.AdamWConfig(lr=LR)
    fl = [leaves[i] for i in floats]
    opt = jadamw.init(fl, ocfg)
    value_and_grad = jax.jit(jax.value_and_grad(loss))
    steps = []
    for s in range(STEPS):
        data = cnn_train.batch(name, tcfg, 0, s, B, device="cpu")
        target = data["mask" if name == "segnet" else "label"]
        l, g = value_and_grad(fl, jnp.asarray(data["image"].numpy()),
                              jnp.asarray(target.numpy().astype(np.int32)))
        before = dict(params=tree([np.asarray(a) for a in fl]),
                      opt=jax.tree_util.tree_map(np.asarray, opt))
        fl, opt = jadamw.update(g, opt, fl, ocfg)
        steps.append(dict(before, loss=float(l), data=data,
                          grads=[np.asarray(a) for a in g],
                          after=[np.asarray(a) for a in fl]))
    return dict(name=name, cfg=tcfg, steps=steps, n_float=len(floats))


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_cnn_training_steps_match_jax(trajectory, backend):
    name, cfg = trajectory["name"], trajectory["cfg"]
    ocfg = adamw.AdamWConfig(lr=LR)
    for s, want in enumerate(trajectory["steps"]):
        params = params_from_numpy(want["params"], device="cpu")
        leaves = cnn_train.float_leaves(params)
        assert len(leaves) == trajectory["n_float"]
        for leaf in leaves:
            leaf.requires_grad_(True)
        opt = params_from_numpy(want["opt"], device="cpu")
        with dispatch.use_backend(backend):
            loss, grads, opt = cnn_train.train_step(name, cfg, params, opt,
                                                    want["data"], ocfg)
        assert abs(loss.item() - want["loss"]) <= 1e-6 * abs(want["loss"]), \
            f"step {s}: loss {loss.item()} vs {want['loss']}"
        assert int(opt.step) == s + 1
        for j, (got, ref) in enumerate(zip(grads, want["grads"])):
            assert got.any() and np.any(ref), f"step {s} leaf {j}: all zero"
            err = _rel_l2(got.numpy(), ref)
            assert err <= 1e-5, f"step {s} gradient leaf {j}: rel L2 {err}"
        for j, (got, ref) in enumerate(zip(leaves, want["after"])):
            err = _rel_l2(got.detach().numpy(), ref)
            assert err <= 1e-5, f"step {s} param leaf {j}: rel L2 {err}"


def test_float_leaves_skip_pool_slots_and_strides():
    for name, n_float in (("vgg11", 9), ("resnet18", 21), ("segnet", 6)):
        cfg = cnn_train.config(name, 2, 0.5)
        params = cnn_train.init_params(name, cfg, device="cpu")
        leaves = cnn_train.float_leaves(params)
        assert len(leaves) == n_float
        assert all(isinstance(x, torch.Tensor) and x.requires_grad
                   for x in leaves)
        opt = adamw.init(leaves, adamw.AdamWConfig(lr=LR))
        assert len(adamw.leaves(opt.mu)) == n_float


def test_segmentation_loss_matches_the_reference_formula():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 8, 8, 2)).astype(np.float32)
    masks = (rng.random((2, 8, 8)) < 0.2).astype(np.int32)
    want = _jax_loss("segnet", None, jnp.asarray(logits), jnp.asarray(masks))
    got = cnn_train.segmentation_loss(torch.from_numpy(logits),
                                      torch.from_numpy(masks).long())
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))


def test_training_resolves_the_card_routes(monkeypatch):
    """With the platform read as `cuda`, a SegNet step resolves the fires,
    `econv` and `tconv` to the kernel routes the card runs (their plain
    versions on these CPU tensors): `cuda`, `cuda-pipe`, `cuda`."""
    monkeypatch.setattr(dispatch, "_platform", lambda args: "cuda")
    cfg = cnn_train.config("segnet", 2, 0.5, img=16)
    params = cnn_train.init_params("segnet", cfg, device="cpu")
    opt = adamw.init(cnn_train.float_leaves(params), adamw.AdamWConfig())
    with dispatch.watch_resolutions() as seen:
        cnn_train.train_step("segnet", cfg, params, opt,
                             cnn_train.batch("segnet", cfg, 0, 0, B, "cpu"),
                             adamw.AdamWConfig())
    routes = {}
    for rec in seen:
        routes.setdefault(rec["op"], set()).add(rec["backend"])
    assert routes == {"lif_scan_occ": {dispatch.CUDA},
                      "econv": {dispatch.CUDA_PIPE},
                      "tconv": {dispatch.CUDA}}, routes
