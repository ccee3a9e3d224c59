"""Helpers shared by the port's model tests: numpy weights in the tree of
a JAX package ``init_params``, the bridge to the port on the CPU, and
tree comparisons.  Not a test module."""

import functools

import jax
import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def no_onednn():
    """torch's oneDNN convolutions corrupt the heap of a process that has
    loaded XLA's CPU backend (half of the runs of a ResNet backward abort
    or segfault); torch's own convolutions do not.  A test module turns
    this on by importing it."""
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = was


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_shapes(init, cfg):
    """The tree of ``init(cfg, key)`` as ShapeDtypeStructs, traced only."""
    return jax.eval_shape(functools.partial(init, cfg), jax.random.PRNGKey(0))


def weights(init, cfg, seed=0):
    """Numpy draws in the tree of the JAX package's ``init(cfg, key)``
    (running JAX's init costs 4-8 s per ResNet on the CPU): weights of 2+
    dims N(0, 1/fan_in) over all but the last dim, norm scales and
    variances 1 + U(-0.1, 0.1), other vectors N(0, 0.1), so biases, BN
    shifts and running means are not zero."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if leaf.ndim >= 2:
            std = np.prod(leaf.shape[:-1]) ** -0.5
            a = rng.standard_normal(leaf.shape) * std
        elif "scale" in name or "var" in name:
            a = 1.0 + rng.uniform(-0.1, 0.1, leaf.shape)
        else:
            a = rng.standard_normal(leaf.shape) * 0.1
        return a.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, jax_shapes(init, cfg))


def bridge(tree):
    return convert.params_from_numpy(tree, device="cpu")


def requiring_grad(tree):
    return convert._map(lambda t: t.requires_grad_(True), bridge(tree))


def grad_tree(loss, params):
    """d loss / d params as a numpy tree of the params' structure (zeros
    for a leaf the loss does not use, as ``jax.grad`` gives)."""
    grads = iter(torch.autograd.grad(loss, convert._leaves(params),
                                     materialize_grads=True))
    return convert._map(lambda _: next(grads).numpy(), params)


def assert_trees_close(got, want, **tol):
    """Same structure, and every leaf within ``tol``."""
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def assert_same_layout(port_tree, jax_tree):
    """The port's tree has ``jax_tree``'s keys, shapes and dtypes (its
    leaves arrays or ShapeDtypeStructs)."""
    got = convert.params_to_numpy(port_tree)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jax_tree))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax_tree)):
        assert g.shape == w.shape and g.dtype == w.dtype
