"""The rounding budget that holds the bf16 tensor-core flash kernels to their
fp32 plain versions (ops/cuda/flash_attention.py `budget_tolerance`), checked
against the kernel it stands for: the Pallas `flash_attention` (interpret mode)
on bf16 inputs, which rounds p (and in the backward ds) to bf16 before its
products, lies within the budget of the port's fp32 plain forward and
backward; a softmax scale or a delta 8% low does not. Power-of-two scales
keep the JAX side's bf16 q * scale exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformerplusplus_tpu.ops.pallas.flash_attention import flash_attention
from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import (
    attention_delta, budget_tolerance, flash_attention_bwd_plain, flash_attention_plain,
    flash_bwd_budget, flash_fwd_budget)

CASES = [(16, 0.25, 300, 321), (64, 0.125, 321, 300)]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(dh, n, m, seed):
    rng = np.random.RandomState(seed)
    q, dout = (rng.randn(2, n, 2, dh) for _ in range(2))
    k, v = (rng.randn(2, m, 2, dh) for _ in range(2))
    bf = [torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16) for x in (q, k, v, dout)]
    jx = [jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16) for x in bf]
    return bf, jx


def _ratio(got, want, budget) -> float:
    """max |got - want| / budget_tolerance: at most 1 where they agree."""
    err = (torch.from_numpy(np.asarray(got, np.float32)) - want.float()).abs()
    return (err / budget_tolerance(want, budget)).max().item()


@pytest.mark.parametrize("dh,scale,n,m", CASES)
def test_pallas_forward_within_the_budget(dh, scale, n, m):
    (q, k, v, _), (jq, jk, jv, _) = _inputs(dh, n, m, dh)
    want = flash_attention_plain(q, k, v, scale)
    budget = flash_fwd_budget(q, k, v, scale)
    assert _ratio(flash_attention(jq, jk, jv, scale), want, budget) <= 1
    assert _ratio(flash_attention(jq, jk, jv, 0.92 * scale), want, budget) > 2


@pytest.mark.parametrize("dh,scale,n,m", CASES)
def test_pallas_backward_within_the_budget(dh, scale, n, m):
    """jax.vjp of the Pallas kernel against the plain backward from the same
    delta (from the Pallas output) and the plain lse."""
    (q, k, v, dout), (jq, jk, jv, jg) = _inputs(dh, n, m, dh + 1)
    out, vjp = jax.vjp(lambda a, b, c: flash_attention(a, b, c, scale), jq, jk, jv)
    got = vjp(jg)
    _, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
    delta = attention_delta(torch.from_numpy(np.asarray(out, np.float32)), dout)
    budgets = flash_bwd_budget(q, k, v, dout, lse, delta, scale)
    want = flash_attention_bwd_plain(q, k, v, dout, lse, delta, scale)
    assert max(_ratio(g, w, b) for g, w, b in zip(got, want, budgets)) <= 1
    bad = flash_attention_bwd_plain(q, k, v, dout, lse, 0.92 * delta, scale)
    assert max(_ratio(g, w, b) for g, w, b in zip(got, bad, budgets)) > 2


def test_budgets_have_the_outputs_shapes_in_f32():
    (q, k, v, dout), _ = _inputs(16, 37, 53, 0)
    out, lse = flash_attention_plain(q, k, v, 0.25, return_lse=True)
    fwd = flash_fwd_budget(q, k, v, 0.25)
    assert fwd.shape == out.shape and fwd.dtype == torch.float32 and bool((fwd > 0).all())
    grads = flash_attention_bwd_plain(q, k, v, dout, lse, attention_delta(out, dout), 0.25)
    budgets = flash_bwd_budget(q, k, v, dout, lse, attention_delta(out, dout), 0.25)
    for g, b in zip(grads, budgets):
        assert b.shape == g.shape and b.dtype == torch.float32 and bool((b >= 0).all())
    tol = budget_tolerance(out, fwd)
    assert tol.shape == out.shape and tol.dtype == torch.float32
