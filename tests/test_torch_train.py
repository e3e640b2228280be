"""The port's training path against the JAX package's trainer on the CPU:
the multibox loss and its hard-negative mining, anchor matching, the label
parser, the letterbox of annotations, the batch iterator, the learning-rate
schedule, three SGD steps with momentum and weight decay (float32 and bf16
compute), the eval step, and batch norm's train-mode update.

MobileNet-0.25 at 64x64, batch 4, ``max_gt`` 8; weights are the JAX
package's random init carried across by ``from_jax_variables``.
"""

import argparse
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from video_desensitization_tpu.cli import train as jax_cli
from video_desensitization_tpu.models.configs import cfg_mnet as jax_cfg_mnet
from video_desensitization_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from video_desensitization_tpu.ops.anchors import generate_anchors
from video_desensitization_tpu.train import data as jax_data
from video_desensitization_tpu.train import step as jax_step
from video_desensitization_tpu.train.losses import multibox_loss as jax_multibox_loss
from video_desensitization_tpu.train.targets import match_anchors as jax_match_anchors

from video_desensitization_torch.cli.train import build_optimizer
from video_desensitization_torch.models.common import BatchNorm2d
from video_desensitization_torch.models.configs import cfg_mnet
from video_desensitization_torch.models.convert import from_jax_variables, to_jax_variables
from video_desensitization_torch.models.retinaface import RetinaFace
from video_desensitization_torch.train import data
from video_desensitization_torch.train.losses import hard_negatives, multibox_loss
from video_desensitization_torch.train.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from video_desensitization_torch.train.targets import match_anchors

HW = (64, 64)
ANCHORS = generate_anchors(HW, min_sizes=jax_cfg_mnet["min_sizes"], steps=jax_cfg_mnet["steps"])
A = len(ANCHORS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's steps at these sizes run no slower on one thread, and on
    a loaded CPU (the suite's workers) each of torch's parallel regions
    waits on threads that have no core: a float64 step ran 8x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _heads(rng, b, a, tie_levels=None):
    loc = rng.normal(0, 1, (b, a, 4)).astype(np.float32)
    landm = rng.normal(0, 1, (b, a, 10)).astype(np.float32)
    if tie_levels is None:
        cls = rng.normal(0, 1, (b, a, 2)).astype(np.float32)
    else:  # few distinct logits: many anchors of exactly equal CE
        cls = rng.choice(tie_levels, (b, a, 2)).astype(np.float32)
    return loc, cls, landm


def _jax_hard_negatives(ce, positive, num_pos, neg_pos_ratio=7.0):
    """The JAX package's mining, as written in its ``multibox_loss``."""
    neg_score = jnp.where(positive, -jnp.inf, ce)
    order = jnp.argsort(-neg_score, axis=1)
    rank = jnp.argsort(order, axis=1)
    num_neg = jnp.minimum((neg_pos_ratio * num_pos).astype(jnp.int32), positive.shape[1] - 1)
    return np.asarray(rank < num_neg[:, None])


def test_multibox_loss_matches_jax_with_tied_logits():
    """Few positives, logits from three levels (so most negatives tie):
    the loss and each metric to rtol 1e-6, the hard negatives exactly."""
    rng = np.random.default_rng(0)
    b = 3
    loc, cls, landm = _heads(rng, b, A, tie_levels=[-0.5, 0.0, 0.75])
    loc_t = rng.normal(0, 1, (b, A, 4)).astype(np.float32)
    landm_t = rng.normal(0, 1, (b, A, 10)).astype(np.float32)
    labels = np.zeros((b, A), np.int32)
    for i, n in enumerate((3, 5, 0)):  # image 2: no positive (num_pos clamps to 1)
        idx = rng.choice(A, n, replace=False)
        labels[i, idx] = rng.choice([-1, 1], n)
    args = (loc, cls, landm, loc_t, landm_t, labels)
    total_j, metrics_j = jax_multibox_loss(*map(jnp.asarray, args))
    total, metrics = multibox_loss(*map(torch.from_numpy, args))
    np.testing.assert_allclose(float(total), float(total_j), rtol=1e-6)
    for k, v in metrics_j.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-6, err_msg=k)

    positive = labels != 0
    num_pos = np.maximum(positive.sum(1), 1)
    logp = torch.log_softmax(torch.from_numpy(cls), dim=-1)
    ce = -torch.gather(logp, -1, torch.from_numpy(positive).long()[..., None])[..., 0]
    mine = hard_negatives(ce, torch.from_numpy(positive), torch.from_numpy(num_pos), 7.0)
    theirs = _jax_hard_negatives(jnp.asarray(ce.numpy()), positive, jnp.asarray(num_pos))
    assert (ce.numpy()[~positive][:, None] == ce.numpy()[~positive][None, :]).sum() > A * b
    np.testing.assert_array_equal(mine.numpy(), theirs)
    assert mine.numpy().sum() == 7 * 3 + 7 * 5 + 7


def _gt(rng, g, n_valid):
    """Padded ground truth: n_valid random faces (some without landmarks)."""
    boxes = np.full((g, 4), -1.0, np.float32)
    landms = np.full((g, 10), -1.0, np.float32)
    xy = rng.uniform(0, 0.7, (n_valid, 2))
    wh = rng.uniform(0.05, 0.3, (n_valid, 2))
    boxes[:n_valid] = np.concatenate([xy, xy + wh], 1)
    pts = xy[:, None, :] + rng.uniform(0, 1, (n_valid, 5, 2)) * wh[:, None, :]
    landms[:n_valid] = pts.reshape(n_valid, 10)
    landms[1] = -1.0  # face 1 has no landmarks: label -1
    valid = np.arange(g) < n_valid
    return boxes, landms, valid


def _match_both(boxes, landms, valid):
    theirs = [np.asarray(t) for t in jax_match_anchors(
        jnp.asarray(boxes), jnp.asarray(landms), jnp.asarray(valid), jnp.asarray(ANCHORS))]
    mine = [t.numpy() for t in match_anchors(
        torch.from_numpy(boxes), torch.from_numpy(landms), torch.from_numpy(valid),
        torch.from_numpy(ANCHORS.copy()))]
    np.testing.assert_array_equal(mine[2], theirs[2])
    for a, b in zip(mine[:2], theirs[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    return mine


@pytest.mark.parametrize("n_valid", [1, 5, 8])
def test_match_anchors_matches_jax(n_valid):
    boxes, landms, valid = _gt(np.random.default_rng(n_valid), 8, n_valid)
    _, _, labels = _match_both(boxes, landms, valid)
    assert labels.dtype == np.int32
    assert (labels == -1).any() == (n_valid > 1)
    assert (labels != 0).sum() >= n_valid  # each face claims an anchor


def test_match_anchors_padding_wins_anchor_zero_as_in_jax():
    """A valid face whose best anchor is anchor 0 (IoU 0.25, under the 0.35
    threshold), then padding: every padded ground truth also claims anchor
    0 and the last claim wins, so the face gets no positive anchor, as in
    the JAX package on the CPU. Without padding it gets anchor 0."""
    face = np.array([0.0, 0.0, 0.125, 0.125], np.float32)
    landm = np.full(10, 0.05, np.float32)
    boxes = np.full((4, 4), -1.0, np.float32)
    landms = np.full((4, 10), -1.0, np.float32)
    boxes[0], landms[0] = face, landm
    _, _, padded = _match_both(boxes, landms, np.array([True, False, False, False]))
    assert (padded == 0).all()
    _, _, alone = _match_both(boxes[:1], landms[:1], np.array([True]))
    assert alone[0] == 1 and (alone[1:] == 0).all()


LABEL_TXT = (
    "# 0--Parade/a.jpg\n"
    "10 20 30 40 1.0 2.0 0.0 3.0 4.0 0.0 5.0 6.0 0.0 7.0 8.0 0.0 9.0 10.0 0.0 0.9\n"
    "50 60 7 8 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 0.8\n"
    "12 14 20 22 1 2 3 4 5 6 7 8 9 10\n"
    "# 1--Other/b.jpg\n"
    "1 2 3 4\n"
    "5 6 0 0\n"  # degenerate box dropped
)


def test_label_parser_matches_jax(tmp_path):
    txt = tmp_path / "label.txt"
    txt.write_text(LABEL_TXT)
    mine = data.load_retinaface_labels(str(txt))
    theirs = jax_data.load_retinaface_labels(str(txt))
    assert sorted(mine) == sorted(theirs) == ["0--Parade/a.jpg", "1--Other/b.jpg"]
    for k in mine:
        assert mine[k].dtype == np.float64
        np.testing.assert_array_equal(mine[k], theirs[k])


@pytest.mark.parametrize(
    "ann, src_hw, dst_hw",
    [
        ([[-5.0, 10.0, 25.0, 50.0] + [-1.0] * 10], (100, 100), (200, 200)),
        ([[-5.0, 10.0, 25.0, 50.0, 3.0, 12.0] + [-1.0] * 8], (100, 100), (200, 200)),
        ([[10.0, 20.0, 90.0, 130.0] + [15.0, 30.0] * 5, [0.0, 0.0, 4.0, 4.0] + [-1.0] * 10],
         (120, 96), (64, 64)),
    ],
    ids=["edge-face", "edge-face-landmark", "two-faces"],
)
def test_letterbox_annotations_match_jax(ann, src_hw, dst_hw):
    ann = np.asarray(ann, np.float64)
    mine = data._letterbox_annotations(ann, src_hw, dst_hw)
    np.testing.assert_array_equal(mine, jax_data._letterbox_annotations(ann, src_hw, dst_hw))
    assert 0.0 <= mine[0, 0] < mine[0, 2] <= 1.0 and 0.0 <= mine[0, 1] < mine[0, 3] <= 1.0


def _synthetic_set(root, n=8):
    """White squares on black, box = the square, with landmarks."""
    import cv2

    lines = []
    for i in range(n):
        img = np.zeros((80, 96, 3), np.uint8)
        x0, y0 = 10 + 5 * i, 18
        img[y0:y0 + 26, x0:x0 + 26] = 255
        cv2.imwrite(str(root / f"im{i}.jpg"), img)
        lm = " ".join(f"{x0 + dx} {y0 + dy} 0" for dx, dy in
                      ((7, 8), (19, 8), (13, 14), (8, 20), (18, 20)))
        lines.append(f"# im{i}.jpg\n{x0} {y0} 26 26 {lm} 1\n" if i % 2 else
                     f"# im{i}.jpg\n{x0} {y0} 26 26\n")
    (root / "label.txt").write_text("".join(lines))
    return data.load_retinaface_labels(str(root / "label.txt"))


def test_batch_iterator_matches_jax(tmp_path):
    """Two epochs (seeds 0 and 1) and the unshuffled remainder: the same
    batches in the same order; images NCHW here, NHWC there."""
    labels = _synthetic_set(tmp_path, 10)
    for kw in (dict(seed=0), dict(seed=1), dict(shuffle=False, drop_remainder=False)):
        mine = list(data.batch_iterator(labels, str(tmp_path), HW, ANCHORS, batch_size=4,
                                        max_gt=8, device="cpu", **kw))
        theirs = list(jax_data.batch_iterator(labels, str(tmp_path), HW, ANCHORS,
                                              batch_size=4, max_gt=8, **kw))
        assert len(mine) == len(theirs) == (3 if "shuffle" in kw else 2)
        for m, t in zip(mine, theirs):
            np.testing.assert_array_equal(m["images"], t["images"].transpose(0, 3, 1, 2))
            np.testing.assert_array_equal(m["labels"], np.asarray(t["labels"]))
            assert (np.abs(m["labels"]).sum(axis=1) >= 1).all()
            for k in ("loc_t", "landm_t"):
                np.testing.assert_allclose(m[k], np.asarray(t[k]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "milestones, warmup",
    [([1000], 5), ([3, 6], 4), ([8, 12], 4), ([2, 3], 0), ([0, 5], 0), ([], 3)],
)
def test_multistep_lr_matches_jax(milestones, warmup):
    mine = data.multistep_lr(1e-3, milestones, gamma=0.1, warmup_steps=warmup)
    theirs = jax_data.multistep_lr(1e-3, milestones, gamma=0.1, warmup_steps=warmup)
    got = np.array([mine(s) for s in range(20)])
    want = np.array([float(theirs(s)) for s in range(20)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if warmup:
        assert got[0] == 0.0


def test_batch_norm_eval_is_torchs_and_train_update_is_flaxs():
    """Eval mode: nn.BatchNorm2d's output bit for bit. Train mode: the
    running statistics take the biased batch variance with momentum 0.9,
    within rtol 1e-6 of float64, also on a channel whose variance (1e-4)
    is small beside its mean (10), where Flax's float32 E[x^2] - E[x]^2 is
    8% off; nn.BatchNorm2d takes the unbiased variance (n = 32)."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (2, 4, 4, 4)).astype(np.float32)
    x[:, 3] = 10.0 + 1e-2 * rng.normal(0, 1, (2, 4, 4))
    x = torch.from_numpy(x)
    running_var = torch.tensor([1.2, 0.7, 3.0, 0.0])
    ours, plain = BatchNorm2d(4), torch.nn.BatchNorm2d(4)
    with torch.no_grad():
        for m in (ours, plain):
            m.weight.copy_(torch.tensor([0.5, 1.5, -1.0, 2.0]))
            m.bias.copy_(torch.tensor([0.1, 0.0, -0.2, 0.3]))
            m.running_mean.copy_(torch.tensor([0.3, -0.1, 2.0, 9.0]))
            m.running_var.copy_(running_var)
    assert torch.equal(ours.eval()(x), plain.eval()(x))
    ours.train()(x)
    xd = x.double()
    np.testing.assert_allclose(
        ours.running_mean.numpy(),
        (0.9 * torch.tensor([0.3, -0.1, 2.0, 9.0]).double() + 0.1 * xd.mean(dim=(0, 2, 3))).numpy(),
        rtol=1e-6)
    var = xd.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               (0.9 * running_var.double() + 0.1 * var).numpy(), rtol=1e-6)
    plain.train()(x)
    assert not torch.allclose(ours.running_var, plain.running_var, rtol=1e-3)


# -- the train step ------------------------------------------------------------


def _jax_variables():
    model = JaxRetinaFace(cfg=jax_cfg_mnet, mode="train", dtype=jnp.float32)
    v = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *HW, 3)))
    return jax.tree.map(np.asarray, dict(v))


@pytest.fixture(scope="module")
def jax_variables():
    return _jax_variables()


def _random_batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.normal(0, 1, (b, *HW, 3)).astype(np.float32),
        "loc_t": rng.normal(0, 1, (b, A, 4)).astype(np.float32),
        "landm_t": rng.normal(0, 1, (b, A, 10)).astype(np.float32),
        "labels": rng.integers(-1, 2, (b, A)).astype(np.int32),
    }


def _nchw(batch):
    out = dict(batch)
    out["images"] = np.ascontiguousarray(batch["images"].transpose(0, 3, 1, 2))
    return out


def _args(lr=1e-3, weight_decay=5e-4, milestones="2"):
    """The optimizer flags of both CLIs: momentum 0.9, no warmup, lr x0.1
    at each milestone (one step an epoch: from step 2 on by default)."""
    return argparse.Namespace(lr=lr, momentum=0.9, weight_decay=weight_decay, gamma=0.1,
                              milestones=milestones, warmup_epochs=0.0)


def _port_state(variables, args, dtype=torch.float32):
    """The port's network on the JAX weights (in ``dtype``) under its CLI's
    ``build_optimizer``."""
    net = RetinaFace(cfg_mnet, mode="train")
    net.load_state_dict(from_jax_variables(variables))
    net.to(dtype)
    optimizer, schedule = build_optimizer(args, 1, net)
    return create_train_state(net, optimizer, schedule, device="cpu")


def _sgd(learning_rate, weight_decay):
    """The JAX CLI's optimizer (``cli/train.py::build_optimizer``): weight
    decay, then SGD with momentum 0.9."""
    return optax.chain(optax.add_decayed_weights(weight_decay),
                       optax.sgd(learning_rate, momentum=0.9))


# the lr and the weight decay live in the optimizer's state, so that one
# compiled JAX step serves every case; each state sets its own
_JAX_TX = optax.inject_hyperparams(_sgd)(learning_rate=0.0, weight_decay=0.0)


def _set_hyperparams(jstate, **values):
    hyperparams = jstate.opt_state.hyperparams
    for k, v in values.items():
        hyperparams[k] = jnp.asarray(v, hyperparams[k].dtype)


def _jax_state(variables, dtype, lr=1e-3, weight_decay=5e-4):
    tree = jax.tree.map(lambda x: jnp.asarray(x, dtype), variables)
    state = jax_step.TrainState(params=tree["params"], batch_stats=tree["batch_stats"],
                                opt_state=_JAX_TX.init(tree["params"]),
                                step=jnp.zeros((), jnp.int32))
    _set_hyperparams(state, learning_rate=lr, weight_decay=weight_decay)
    return state


@functools.lru_cache(maxsize=None)
def _jax_train_step(dtype):
    """The JAX train step with compute dtype ``dtype`` under ``_JAX_TX``,
    compiled once per module."""
    model = JaxRetinaFace(cfg=jax_cfg_mnet, mode="train", dtype=dtype)
    return jax_step.make_train_step(model, _JAX_TX, ANCHORS)


def _tree(state):
    return jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})


def _jax_momentum(opt_state):
    """The momentum buffers (optax's trace) of the JAX optimizer's state."""
    (trace,) = [s.trace for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    return jax.tree.map(np.asarray, trace)


def _port_params(state, tensors):
    """``tensors`` (float64, by parameter name) in the JAX params layout."""
    sd = dict(state.model.state_dict())
    sd.update(tensors)
    return to_jax_variables(sd)["params"]


def _params64(state):
    return {k: p.detach().double().clone() for k, p in state.model.named_parameters()}


def _port_momentum(state):
    return _port_params(state, {k: state.optimizer.state[p]["momentum_buffer"].double()
                                for k, p in state.model.named_parameters()})


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _relative_errors(mine, want):
    """|mine - want| / |want| (Frobenius) for each leaf whose ``want`` is
    not zero, and over all leaves together."""
    m, w = _flat(mine), _flat(want)
    assert m.keys() == w.keys()
    per_leaf = {k: float(np.linalg.norm(m[k] - w[k]) / np.linalg.norm(w[k]))
                for k in w if np.any(w[k])}
    total = np.sqrt(sum(float(np.sum((m[k] - w[k]) ** 2)) for k in w)
                    / sum(float(np.sum(v ** 2)) for v in w.values()))
    return per_leaf, float(total)


def _assert_trees_close(mine, theirs, rtol, atol):
    flat_m = jax.tree_util.tree_flatten_with_path(mine)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in flat_m] == [p for p, _ in flat_t]
    for (path, m), (_, t) in zip(flat_m, flat_t):
        np.testing.assert_allclose(m, np.asarray(t, np.float64), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _batch64(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}


@pytest.mark.parametrize(
    "dtype, lr, weight_decay, milestones",
    [(torch.float64, 1e-3, 5e-4, "2"), (torch.float64, 1e-3, 0.5, "2"),
     (torch.float32, 1e-4, 5e-4, "")],
    ids=["float64-wd5e-4", "float64-wd0.5", "float32-wd5e-4"],
)
def test_three_sgd_steps_match_jax(jax_variables, dtype, lr, weight_decay, milestones):
    """Three steps of the port's train step under its CLI's
    ``build_optimizer`` (momentum 0.9, lr x0.1 at step 2) against the JAX
    trainer's step under the JAX CLI's, run in float64
    (``jax.enable_x64``), from the same weights on the same batch. After
    each step: the update (parameters after minus before) and the momentum
    buffers, as |port - JAX| / |JAX| (Frobenius), the loss, every parameter
    and every BN running statistic.

    float64 network (the loss in float32 in both, as the trainers take it),
    at the CLI's lr 1e-3, with the CLI's weight decay and with 0.5, where
    decay is much of the update: each leaf's update, momentum and BN
    statistics within 1e-6 relative, the loss within rtol 1e-6.

    float32, the trainer's dtype, at a constant lr 1e-4: the update over all
    parameters within 1e-3 relative (float32 rounding of the parameters is
    that large next to a step this small), the momentum within 1e-4 (the
    CLI's weight decay alone moves it 8e-4), loss, parameters and
    statistics within rtol = atol = 1e-5, and the loss within 1e-5 of the
    JAX float32 step's. The JAX float32 step is no reference for more: on
    the CPU its gradient of the stem kernel is itself 2e-2 off its float64
    value, and the gradient of a random-init network is not smooth in the
    weights (in float64, moving every weight by 1e-7 moved it by 7e-4), so
    two float32 runs part beyond 1e-5 after the second step at any lr from
    1e-4 to 1e-2; at lr 1e-3 the port's float32 steps part from the
    float64 ones likewise."""
    batch = _random_batch()
    args = _args(lr, weight_decay, milestones)
    state = _port_state(jax_variables, args, dtype)
    train_step = make_train_step()
    _, schedule = jax_cli.build_optimizer(args, 1)
    step64 = _jax_train_step(jnp.float64)
    with jax.enable_x64():
        jstate = _jax_state(jax_variables, jnp.float64, weight_decay=weight_decay)
    float32 = dtype == torch.float32
    if float32:
        step32 = _jax_train_step(jnp.float32)
        jstate32 = _jax_state(jax_variables, jnp.float32, weight_decay=weight_decay)
    mine_batch = _nchw(batch if float32 else _batch64(batch))
    for i in range(3):
        before = _params64(state)
        state, metrics = train_step(state, mine_batch)
        after = _params64(state)
        update = _port_params(state, {k: after[k] - before[k] for k in after})
        with jax.enable_x64():
            _set_hyperparams(jstate, learning_rate=float(schedule(i)))
            params_before = jax.tree.map(np.asarray, jstate.params)
            jstate, jmetrics = step64(jstate, _batch64(batch))
            want = _tree(jstate)
            want_update = jax.tree.map(lambda a, b: a - b, want["params"], params_before)
            want_momentum = _jax_momentum(jstate.opt_state)
        assert state.step == i + 1
        loss, want_loss = float(metrics["loss"]), float(jmetrics["loss"])
        update_err, update_total = _relative_errors(update, want_update)
        momentum_err, momentum_total = _relative_errors(_port_momentum(state), want_momentum)
        mine = to_jax_variables(state.model.state_dict())
        if float32:
            _set_hyperparams(jstate32, learning_rate=float(schedule(i)))
            jstate32, jmetrics32 = step32(jstate32, batch)
            np.testing.assert_allclose(loss, float(jmetrics32["loss"]), rtol=1e-5)
            np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
            assert update_total <= 1e-3, (i, update_total)
            assert momentum_total <= 1e-4, (i, momentum_total)
            _assert_trees_close(mine, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
            for name, errors in (("update", update_err), ("momentum", momentum_err)):
                worst = max(errors, key=errors.get)
                assert errors[worst] <= 1e-6, (i, name, worst, errors[worst])
            stats_err, _ = _relative_errors(mine["batch_stats"], want["batch_stats"])
            worst = max(stats_err, key=stats_err.get)
            assert stats_err[worst] <= 1e-6, (i, worst, stats_err[worst])
    assert all(p.dtype == dtype for p in state.model.parameters())
    momentum = state.optimizer.state[next(state.model.parameters())]["momentum_buffer"]
    assert momentum.dtype == dtype


def _head_leaves(errors):
    return [v for k, v in errors.items() if "Head" in k]


@pytest.mark.parametrize("weight_decay", [5e-4, 0.5], ids=["wd5e-4", "wd0.5"])
def test_bfloat16_step_keeps_float32_params_and_tracks_jax(jax_variables, weight_decay):
    """--compute-dtype bfloat16: the forward and backward under autocast,
    parameters, momentum and BN statistics float32. One step at lr 1e-3
    against the JAX bf16 step: the loss to rtol 2e-2. Its update against
    the JAX float64 step's, as |bf16 - float64| / |float64| for each leaf:
    no farther than twice what the JAX bf16 step's is, at the worst leaf of
    the heads (the last layers, whose bf16 gradient is good to about 0.1
    to 0.3) and at the median over all leaves (the backbone's bf16 gradient
    is about as far from the float64 one as it is long, in either package,
    so at the CLI's weight decay only the heads' test has teeth; at 0.5,
    where decay is much of each update, the median's has too). An update
    of zero, or one without the weight decay, is 1.0 off at the heads'
    worst leaf. The loss still falls over five steps."""
    batch = _random_batch()
    state = _port_state(jax_variables, _args(1e-3, weight_decay))
    train_step = make_train_step(torch.bfloat16)
    jstate = _jax_state(jax_variables, jnp.float32, weight_decay=weight_decay)
    jparams = jax.tree.map(np.asarray, jstate.params)
    before = _params64(state)
    state, metrics = train_step(state, _nchw(batch))
    after = _params64(state)
    jstate, jmetrics = _jax_train_step(jnp.bfloat16)(jstate, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=2e-2)
    with jax.enable_x64():
        j64 = _jax_state(jax_variables, jnp.float64, weight_decay=weight_decay)
        params64 = jax.tree.map(np.asarray, j64.params)
        j64, _ = _jax_train_step(jnp.float64)(j64, _batch64(batch))
        want = jax.tree.map(lambda a, b: np.asarray(a) - b, j64.params, params64)
    mine, _ = _relative_errors(_port_params(state, {k: after[k] - before[k] for k in after}), want)
    theirs, _ = _relative_errors(
        jax.tree.map(lambda a, b: np.asarray(a, np.float64) - b, jstate.params, jparams), want)
    assert max(_head_leaves(mine)) <= 2 * max(_head_leaves(theirs)), (
        max(_head_leaves(mine)), max(_head_leaves(theirs)))
    assert np.median(list(mine.values())) <= 2 * np.median(list(theirs.values())), (
        np.median(list(mine.values())), np.median(list(theirs.values())))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(b.dtype == torch.float32 for b in state.model.buffers() if b.is_floating_point())
    losses = [float(metrics["loss"])]
    for _ in range(4):
        state, metrics = train_step(state, _nchw(batch))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_eval_step_matches_jax(jax_variables):
    """BN in inference mode, no gradient: the metrics of the JAX eval step
    to rtol 1e-5; the model's state is untouched and it is left training."""
    batch = _random_batch(seed=1)
    state = _port_state(jax_variables, _args())
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    metrics = make_eval_step()(state, _nchw(batch))
    model = JaxRetinaFace(cfg=jax_cfg_mnet, mode="train", dtype=jnp.float32)
    jstate = _jax_state(jax_variables, jnp.float32)
    jmetrics = jax_step.make_eval_step(model)(jstate, batch)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    assert state.model.training
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in before.items())
    assert all(p.grad is None for p in state.model.parameters())
