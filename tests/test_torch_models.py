"""The port's networks against the JAX package's on the same weights.

Weights start as a reference-layout torch state_dict (tests/torch_oracle.py,
BN statistics randomised). The JAX side gets them through its own
converter; the port loads them with ``load_state_dict`` as they are, and a
second copy goes JAX variables -> ``from_jax_variables`` -> port. Outputs
are compared in float32 at rtol/atol 1e-4: XLA and oneDNN sum the
convolutions in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_desensitization_tpu.models.configs import cfg_mnet as jax_cfg_mnet
from video_desensitization_tpu.models.configs import cfg_re50 as jax_cfg_re50
from video_desensitization_tpu.models.convert import (
    convert_retinaface_state_dict,
    convert_yolo_state_dict,
)
from video_desensitization_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from video_desensitization_tpu.models.yolo import YoloV8 as JaxYoloV8

from torch_oracle import TRetinaFaceOracle, TYoloV8Oracle, _randomize_bn_stats

from video_desensitization_torch.models.configs import get_config
from video_desensitization_torch.models.convert import from_jax_variables, to_jax_variables
from video_desensitization_torch.models.retinaface import RetinaFace
from video_desensitization_torch.models.yolo import YoloV8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are tiny and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


TOL = dict(rtol=1e-4, atol=1e-4)


def _oracle_state(oracle, seed):
    with torch.no_grad():
        _randomize_bn_stats(oracle, torch.Generator().manual_seed(seed))
    return oracle.eval().state_dict()


def _loaded(net, state):
    net.load_state_dict(state)  # strict: no missing or unexpected keys
    return net.eval()


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)


def _assert_same_tree(a, b):
    """Same Flax tree structure and bitwise-equal leaves."""
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize(
    "backbone,size,batch",
    [("mobilenet", 128, 2), ("resnet50", 64, 1)],
)
def test_retinaface_matches_jax(backbone, size, batch):
    state = _oracle_state(TRetinaFaceOracle(backbone=backbone), seed=7)
    jax_vars = convert_retinaface_state_dict(state)
    cfg = get_config(backbone)
    direct = _loaded(RetinaFace(cfg), state)
    via_jax = _loaded(RetinaFace(cfg), from_jax_variables(jax_vars))
    _assert_same_state(direct, via_jax)
    _assert_same_tree(to_jax_variables(state), jax_vars)

    x = np.random.default_rng(0).normal(0, 1, (batch, size, size, 3)).astype(np.float32)
    jax_net = JaxRetinaFace(
        cfg=jax_cfg_mnet if backbone == "mobilenet" else jax_cfg_re50,
        mode="eval", dtype=jnp.float32,
    )
    want = jax_net.apply(jax_vars, jnp.asarray(x))
    with torch.inference_mode():
        got = via_jax(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_yolov8n_matches_jax():
    torch.manual_seed(0)
    state = _oracle_state(TYoloV8Oracle(), seed=3)
    jax_vars = convert_yolo_state_dict(state)
    direct = _loaded(YoloV8(variant="n"), state)
    via_jax = _loaded(YoloV8(variant="n"), from_jax_variables(jax_vars))
    _assert_same_state(direct, via_jax)
    _assert_same_tree(to_jax_variables(state), jax_vars)

    x = np.random.default_rng(1).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    want = JaxYoloV8(variant="n", dtype=jnp.float32).apply(jax_vars, jnp.asarray(x))
    with torch.inference_mode():
        got = via_jax(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("arch", ["mobilenet", "yolo"])
def test_jax_init_tree_converts_completely(arch):
    """The tree the JAX package's own init builds (not one from a
    checkpoint) covers every key of the port's module under strict loading."""
    if arch == "yolo":
        jax_net, port = JaxYoloV8(variant="n", dtype=jnp.float32), YoloV8(variant="n")
    else:
        jax_net = JaxRetinaFace(cfg=jax_cfg_mnet, mode="eval", dtype=jnp.float32)
        port = RetinaFace(get_config("mobilenet"))
    shapes = jax.eval_shape(jax_net.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    _loaded(port, from_jax_variables(variables))
