"""Helpers for the parity tests of the PyTorch port against the JAX package:
seeded random flax variables, conversion into the port and fp32 comparison."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from mvsformerplusplus_tpu_torch.convert import from_jax_variables

ATOL = RTOL = 2e-4


def init_flax(module, *args, seed=0, **kwargs):
    """Random flax variables for `module` without compiling its init: shapes
    from jax.eval_shape, values from a numpy seed. Kernels are N(0, 1/fan_in);
    scales, gammas and BatchNorm variances U(0.5, 1.5); biases and running
    means N(0, 0.1²), so every parameter and statistic is exercised."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda r: module.init(r, *args, **kwargs), jax.random.PRNGKey(0))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "pos_embed":
            x = rng.randn(*shape) * 0.02
        elif len(shape) >= 2:
            x = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("bias", "mean"):
            x = rng.randn(*shape) * 0.1
        else:
            x = rng.uniform(0.5, 1.5, shape)
        return jnp.asarray(np.asarray(x, dtype=np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def load_port(torch_module, variables):
    """Load converted flax variables strictly into an eval-mode torch module."""
    torch_module.load_state_dict(from_jax_variables(variables), strict=True)
    return torch_module.eval()


def t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def assert_close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32), atol=atol, rtol=rtol)
