"""tools/dino_match.py on the port's ViT against the JAX tool, on the CPU.

- The same DINOv2-B weights (flax's initialisation from PRNGKey(0), as the
  JAX tool's test draws them; both tools' `params=`) on
  the same pair of blocky images: the port's matches are the JAX tool's
  (the same A-side patches, points within 1e-3 px).
- A random ViT still maps identical patches to identical tokens, so an
  image matched against a shifted copy of itself recovers the shift (the
  JAX test's check), through `model=` as well.
- data/image.resize_area on uint8 images equals cv2.resize(INTER_AREA) bit
  for bit at the matcher's working sizes (integer and fractional shrinks).
- The JAX tool's `make_dino_matcher(vit_path)` indexes load_vit_tree(...)
  ["params"], a key that tree does not have; the port loads the file
  itself (its .pth/.npz loaders are tests/test_torch_vit_pth.py's)."""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu.models.dino import DinoVisionTransformer as JaxViT
from mvsformerplusplus_tpu_torch.data.image import resize_area
from mvsformerplusplus_tpu_torch.tools import dino_match
from tools.dino_match import make_dino_matcher as jax_make_dino_matcher

H, W = 154, 210  # 11 x 15 patches


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """Flax's own initialisation of DINOv2-B, as the JAX tool's test draws it."""
    return jax.jit(JaxViT().init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]


@pytest.fixture(scope="module")
def port_matcher(params):
    return dino_match.make_dino_matcher(long_side=max(H, W), params=params, device="cpu")


def _textured(rng, h, w):
    """Piecewise-constant 14-px cells: each patch distinctive."""
    cells = rng.randint(0, 255, (h // 14, w // 14, 3), np.uint8)
    return np.kron(cells, np.ones((14, 14, 1), np.uint8))


def test_matches_equal_the_jax_tools(params, port_matcher):
    rng = np.random.RandomState(2)
    # a 2x larger pair: both tools area-shrink it to the 154 x 210 working size
    a = _textured(rng, 2 * H, 2 * W)
    b = np.roll(a, 28, axis=1)
    want = jax_make_dino_matcher(long_side=max(H, W), params=params)(a, b)
    got = port_matcher(a, b)
    assert len(want[0]) >= 20 and len(got[0]) == len(want[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)


def test_shift_recovered(params):
    vit = dino_match._vit_from(None, params, torch.device("cpu"))
    match_fn = dino_match.make_dino_matcher(long_side=max(H, W), model=vit, device="cpu")
    img = _textured(np.random.RandomState(1), H, W)
    pa, pb = match_fn(img, np.roll(img, 28, axis=1))  # 2 patches right, wrapping
    assert len(pa) >= 20
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    assert np.mean(np.abs(dx - 28) < 7.5) > 0.7
    assert np.mean(np.abs(dy) < 7.5) > 0.7


@pytest.mark.parametrize("src,dst", [((308, 420), (154, 210)), ((462, 630), (154, 210)),
                                     ((480, 640), (476, 630)), ((1152, 1536), (490, 644)),
                                     ((309, 421), (154, 210))])
def test_resize_area_takes_uint8_as_cv2(src, dst):
    rng = np.random.RandomState(src[0])
    for shape in (src + (3,), src):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        got = resize_area(img, *dst)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, cv2.resize(img, dst[::-1],
                                                      interpolation=cv2.INTER_AREA))


def test_jax_tool_vit_path_keyerror_is_not_copied(tmp_path, params):
    """The JAX tool raises KeyError('params') for any vit_path; the port's
    loads the same weights from the .npz the JAX converter writes."""
    from tools.convert_dinov2 import load_vit_tree

    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if hasattr(v, "items"):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(params)
    np.savez(tmp_path / "vit.npz", **flat)
    assert "params" not in load_vit_tree(tmp_path / "vit.npz")
    with pytest.raises(KeyError, match="params"):
        jax_make_dino_matcher(tmp_path / "vit.npz")
    from_path = dino_match._vit_from(tmp_path / "vit.npz", None, torch.device("cpu"))
    from_params = dino_match._vit_from(None, params, torch.device("cpu"))
    for (k, x), (_, y) in zip(from_path.state_dict().items(), from_params.state_dict().items()):
        assert torch.equal(x, y), k
