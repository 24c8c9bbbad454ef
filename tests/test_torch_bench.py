"""The port's benchmark entry point (mvsformerplusplus_tpu_torch.bench), its
product count (ops/cuda/flops.py) and the trace profilers' rollup, on the
CPU: the batches bit for bit the repo's bench.py's; the two models' trees
the two flax models' of bench.py (jax.eval_shape of init, converted); each
kernel formula FlopCounterMode's count of the plain version; the eval and
train legs at a tiny width in fp32 against the JAX forward and
make_train_step, from converted weights, with the tolerances of
test_torch_flagship.py (depth rtol 1e-3 where testing.well_conditioned
holds) and test_torch_train_step.py (losses rtol 1e-5, gradients 1e-3 of a
tensor's largest entry + 5e-5, BatchNorm statistics rtol 1e-4 atol 2e-5,
parameters atol 1e-6, or twice the learning rates summed where a gradient
was within noise); the JSON line's keys; the card-only entry points."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mvsformerplusplus_tpu.models.mvsformer import DINOv2MVSNet as JaxFlagship
from mvsformerplusplus_tpu.train.optim import make_optimizer as jax_make_optimizer
from mvsformerplusplus_tpu.train.step import TrainState, make_train_step
from mvsformerplusplus_tpu_torch import bench
from mvsformerplusplus_tpu_torch.config import build_model, load_config
from mvsformerplusplus_tpu_torch.convert import from_jax_variables
from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
from mvsformerplusplus_tpu_torch.ops.cuda import flops
from mvsformerplusplus_tpu_torch.ops.cuda.conv2d import (Conv2dSame, conv2d_same_dx_plain,
                                                         conv2d_same_plain)
from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import (FlashAttention,
                                                                  flash_attention_plain)
from mvsformerplusplus_tpu_torch.ops.cuda.warp import (WarpBilinear, warp_bilinear_bwd_plain,
                                                       warp_bilinear_plain)
from mvsformerplusplus_tpu_torch.testing import conditioned_train_batch, well_conditioned
from mvsformerplusplus_tpu_torch.tools import profile_eval, profile_train
from mvsformerplusplus_tpu_torch.train.optim import make_optimizer
from mvsformerplusplus_tpu_torch.train import step as step_module
from mvsformerplusplus_tpu_torch.train.step import train_step
from mvsformerplusplus_tpu_torch.train.trainer import to_device
from mvsformerplusplus_tpu_torch.utils import profiler
from tests.test_casmvs import make_inputs
from tests.test_torch_flagship import TINY
from tests.test_torch_train_step import capture_grads
from tests.torch_parity import init_flax, t

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def repo_bench():
    """The repo's bench.py, loaded from its file (it imports jax only in
    main)."""
    spec = importlib.util.spec_from_file_location("repo_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kwargs", [{}, dict(b=2, v=3, h=64, w=128, dfull=24)],
                         ids=["defaults", "small"])
def test_batches_equal_bench_py(repo_bench, kwargs):
    eval_kwargs = dict(kwargs, seed=3) if kwargs else {}
    _equal(bench.make_dtu_eval_batch(**eval_kwargs), repo_bench.make_dtu_eval_batch(**eval_kwargs))
    _equal(bench.make_train_batch(**kwargs), repo_bench.make_train_batch(**kwargs))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_model_trees_equal_bench_py(train):
    """bench.py's flax model (DINOv2MVSNet(dtype=bf16) with remat_stages
    False, or True at "cost_reg"): its variables' names and shapes from
    jax.eval_shape of init on a small image, converted, are the bench
    model's state_dict's."""
    kw = dict(remat_stages=True, remat_granularity="cost_reg") if train else dict(
        remat_stages=False)
    jm = JaxFlagship(dtype=jnp.bfloat16, **kw)
    imgs, cams, dv = make_inputs(np.random.RandomState(0), v=2, h=64, w=64)
    shapes = jax.eval_shape(lambda r: jm.init(r, imgs, cams, dv, train=False),
                            jax.random.PRNGKey(0))
    want = from_jax_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    with torch.device("meta"):
        model = DINOv2MVSNet(dtype=torch.bfloat16,
                                   **(bench.TRAIN_ARGS if train else bench.EVAL_ARGS))
    got = model.state_dict()
    assert len(got) > 700
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                           for k, v in want.items()}


def _settings(model):
    """Every module's plain attributes (widths, flags, scales) by name."""
    return {f"{n}.{k}": v for n, mod in model.named_modules() for k, v in vars(mod).items()
            if not k.startswith("_") and isinstance(v, (int, float, str, bool, tuple, type(None)))}


def test_bench_model_is_the_config_model():
    """The bench's eval model (the class's defaults) is the model
    configs/mvsformerplusplus.json builds, weight for weight from the same
    seed and setting for setting, but for the remat flags, which do nothing
    in an eval forward and which the config sets as the bench's train model
    does (TRAIN_ARGS)."""
    cfg = load_config(REPO / "configs" / "mvsformerplusplus.json")
    got = bench.build(False, device="cpu")
    want = build_model(cfg, device="cpu")
    a, b = got.state_dict(), want.state_dict()
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    settings = _settings(want)
    diff = {k for k, v in _settings(got).items() if settings.get(k, "?") != v}
    remat = {"cascade.remat_stages"} | {f"cascade.stage{i}.remat_cost_reg" for i in range(1, 5)}
    assert diff == remat and not got.training
    assert (want.cascade.remat_stages, want.cascade.remat_granularity) == (
        bench.TRAIN_ARGS["remat_stages"], bench.TRAIN_ARGS["remat_granularity"])


# the head dims the flash kernels take: each instantiated width and some
# that the wrappers zero-pad
HEAD_DIMS = (1, 8, 16, 24, 32, 48, 64, 100, 128)


def _flop_count(fn) -> int:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return mode.get_total_flops()


def _qkv(n, m, dh, b=2, h=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, dh, generator=g, requires_grad=True) for s in (n, m, m)]


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("n,m", [(1, 1), (37, 51), (64, 17)])
def test_flash_formulas_are_flop_counter_counts(n, m, dh):
    """The forward's formula is FlopCounterMode's count of the plain forward,
    forward + backward that of the plain forward and its autograd backward;
    the wrappers (FlashAttention on CPU tensors) count the same through
    ProductCount, not the plain backward's recompute of S."""
    q, k, v = _qkv(n, m, dh)
    fwd, bwd = flops.flash_fwd_products(q, k), flops.flash_bwd_products(q, k)
    assert fwd == 4 * 2 * 3 * n * m * dh and bwd == 2 * fwd
    assert _flop_count(lambda: flash_attention_plain(q, k, v, 0.3)) == fwd
    assert _flop_count(lambda: flash_attention_plain(q, k, v, 0.3).sum().backward()) == fwd + bwd
    with flops.ProductCount() as count:
        FlashAttention.apply(q, k, v, 0.3).sum().backward()
    assert count.kernels == {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd}
    assert count.library == 0 and count.total == fwd + bwd


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("shape", [(1, 9, 13, 3, 8), (2, 16, 11, 8, 16), (1, 7, 5, 16, 4)])
def test_conv_formulas_are_flop_counter_counts(k, shape):
    """conv2d_same and its dx: 2·B·H·W·ky·kx·Ci·Co each, FlopCounterMode's
    count of the plain versions; the forward and autograd backward of the
    plain conv count fwd + dx + dk, as Conv2dSame does through ProductCount
    (dk is torch matmuls on both routes)."""
    b, h, w, ci, co = shape
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, h, w, ci, generator=g, requires_grad=True)
    kern = torch.randn(k, k, ci, co, generator=g, requires_grad=True)
    gy = torch.randn(b, h, w, co, generator=g)
    n = flops.conv_products(x, kern.shape)
    assert n == 2 * b * h * w * k * k * ci * co
    assert flops.conv_products(gy, kern.shape) == n
    assert _flop_count(lambda: conv2d_same_plain(x, kern)) == n
    assert _flop_count(lambda: conv2d_same_dx_plain(gy, kern)) == n
    assert _flop_count(lambda: (conv2d_same_plain(x, kern) * gy).sum().backward()) == 3 * n
    with flops.ProductCount() as count:
        (Conv2dSame.apply(x, kern) * gy).sum().backward()
    assert count.kernels == {"conv2d_same": n, "conv2d_same_dx": n}
    assert count.library == n and count.total == 3 * n


def test_warp_counts_no_products():
    """The warp and its backward are gathers and blends: FlopCounterMode
    finds no product in their plain versions, and the wrappers count none."""
    g = torch.Generator().manual_seed(2)
    src = torch.randn(2, 9, 11, 8, generator=g, requires_grad=True)
    coords = torch.rand(2, 3, 5, 7, 2, generator=g) * 12 - 1
    assert _flop_count(lambda: warp_bilinear_plain(src, coords)) == 0
    assert _flop_count(lambda: warp_bilinear_bwd_plain(torch.ones(2, 3, 5, 7, 8), coords,
                                                       src.shape)) == 0
    with flops.ProductCount() as count:
        WarpBilinear.apply(src, coords).sum().backward()
    assert count.total == 0 and count.kernels == {}


@pytest.fixture(scope="module")
def tiny_batch():
    return to_device(conditioned_train_batch(), "cpu")


def _tiny(train, **kwargs):
    return bench.build(train, torch.float32, "cpu", **{**TINY, **kwargs})


def test_tiny_flagship_forward_count():
    """A whole tiny flagship forward counts the same through ProductCount as
    under FlopCounterMode alone (each kernel's formula is its plain
    version's count), the flash and conv wrappers' share included."""
    torch.set_num_threads(1)
    model = _tiny(False)
    imgs, cams, dv = bench.make_dtu_eval_batch(v=3, h=64, w=128, dfull=48)
    inputs = (t(imgs), {k: t(c) for k, c in cams.items()}, t(dv))
    with torch.inference_mode():
        alone = _flop_count(lambda: model(*inputs))
        with flops.ProductCount() as count:
            model(*inputs)
    assert set(count.kernels) == {"flash_attention_fwd", "conv2d_same"}
    assert count.library > 0 and count.total == alone


def test_tiny_flagship_step_count(tiny_batch):
    """A train step counts the same with the cascade's remat off, at
    "cost_reg" and at "stage" (a checkpoint's replay is not counted), and
    with remat off FlopCounterMode alone counts more by exactly the plain
    flash backward's recompute of S (2·B·H·N·M·Dh a call: a quarter of the
    backward's formula)."""
    torch.set_num_threads(1)
    totals = {}
    for remat in ("off", "cost_reg", "stage"):
        model = _tiny(True, remat_stages=remat != "off",
                      remat_granularity="stage" if remat == "off" else remat)
        opt, sched = make_optimizer(model, **bench.OPT_ARGS)
        state = {k: v.clone() for k, v in model.state_dict().items()}
        with flops.ProductCount() as count:
            train_step(model, opt, sched, tiny_batch)
        totals[remat] = count.total
        if remat == "off":
            model.load_state_dict(state)
            alone = _flop_count(lambda: train_step(model, opt, sched, tiny_batch))
            kernels = count.kernels
    assert set(kernels) == {"flash_attention_fwd", "flash_attention_bwd", "conv2d_same",
                            "conv2d_same_dx"}
    assert totals["off"] == totals["cost_reg"] == totals["stage"]
    assert alone == totals["off"] + kernels["flash_attention_bwd"] // 4


@pytest.fixture(scope="module")
def jax_model_and_vars():
    batch = conditioned_train_batch()
    jm = JaxFlagship(**TINY, remat_stages=False)
    return jm, init_flax(jm, batch["imgs"], batch["cams"], batch["depth_values"], train=False)


def _converted(train, variables):
    model = _tiny(train)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model.train(train)


def test_eval_leg_against_jax(jax_model_and_vars):
    """bench_eval's depth maps on converted weights are the JAX forward's
    (rtol 1e-3 where the hypotheses are well conditioned, as
    test_torch_flagship holds them)."""
    torch.set_num_threads(1)
    jm, variables = jax_model_and_vars
    imgs, cams, dv = make_inputs(np.random.RandomState(0), h=64, w=128)
    want = jax.jit(lambda v: jm.apply(v, imgs, cams, dv, train=False))(variables)
    res = bench.bench_eval(_converted(False, variables), t(imgs),
                           {k: t(c) for k, c in cams.items()}, t(dv), iters=1)
    mask = well_conditioned(want["stage4"]["depth_values"], far=8.0)
    assert mask.mean() > 0.5 and res["finite"] and res["flops"] > 0
    np.testing.assert_allclose(res["depth"].numpy()[mask],
                               np.asarray(want["refined_depth"])[mask], rtol=1e-3, atol=0)


def test_train_leg_against_jax(jax_model_and_vars, tiny_batch, monkeypatch):
    """bench_train (a first, a counted and one timed step) on converted
    weights against three steps of the JAX make_train_step under
    make_optimizer(total_steps=10000, warmup_steps=500, freeze_vit=True):
    every step's losses; the gradients of steps 1 and 2, both taken at the
    converted weights (the warmup's first rate is 0), and the parameters
    after the second update; the BatchNorm running statistics after the
    third. Step 3's gradients, and so the third update, are not held to the
    JAX ones: Adam moves an entry whose gradient is within the two
    frameworks' noise by its rate in either direction, and at this size
    that changes the next gradients by far more than their tolerance (the
    losses stay within 1e-5)."""
    torch.set_num_threads(1)
    jm, variables = jax_model_and_vars
    tx = optax.chain(capture_grads(), jax_make_optimizer(**bench.OPT_ARGS))
    state = TrainState.create(variables, tx)
    step = jax.jit(make_train_step(jm, tx))
    jb = jax.tree.map(jnp.asarray, conditioned_train_batch())
    want_losses, grads, params = [], [], []
    for _ in range(3):
        state, logs = step(state, jb)
        want_losses.append({k: float(v) for k, v in logs.items()
                            if k == "loss" or k.startswith("stage")})
        grads.append(from_jax_variables({"params": jax.device_get(state.opt_state[0])}))
        params.append(from_jax_variables({"params": jax.device_get(state.params)}))
    stats = from_jax_variables({"batch_stats": jax.device_get(state.batch_stats)})
    port_grads, port_params = [], []

    def recorded_step(model, *args, **kwargs):
        logs = train_step(model, *args, **kwargs)
        port_grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None})
        port_params.append({n: p.detach().clone() for n, p in model.named_parameters()})
        return logs

    monkeypatch.setattr(step_module, "train_step", recorded_step)
    model = _converted(True, variables)
    res = bench.bench_train(model, tiny_batch, iters=1)
    assert res["loss_finite"] and len(res["losses"]) == len(port_grads) == 3
    for got, want in zip(res["losses"], want_losses):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for got, want in zip(port_grads[:2], grads[:2]):
        assert len(got) > 300
        for name, g in got.items():
            w = want[name].numpy()
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-3 * np.abs(w).max() + 5e-5, (name, err)
    lrs = 1e-3 * np.arange(2) / 500  # the warmup's first two rates
    for name, p in port_params[1].items():
        got, want = p.numpy(), params[1][name].numpy()
        if name.startswith("vit."):
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert name not in port_grads[-1], name
            continue
        noisy = np.any([np.abs(g[name].numpy()) < 5e-5 for g in grads[:2]], axis=0)
        np.testing.assert_allclose(got[~noisy], want[~noisy], rtol=0, atol=1e-6, err_msg=name)
        assert np.abs(got[noisy] - want[noisy]).max(initial=0) <= 2 * lrs.sum() + 1e-6, name
    sd = model.state_dict()
    assert len(stats) > 80
    for k in (k for k in stats if k.endswith(("running_mean", "running_var"))):
        np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(), rtol=1e-4, atol=2e-5,
                                   err_msg=k)


def test_json_line_has_bench_py_keys():
    """run() at a tiny width on the CPU: bench.py's keys, compile_s and
    train_compile_s renamed first_call_s and train_first_call_s, and
    power_limit_w added; no MFU, peak or power limit for the CPU."""
    torch.set_num_threads(1)
    res = bench.run(device="cpu", dtype=torch.float32, model_kwargs=TINY,
                    eval_batch=bench.make_dtu_eval_batch(v=3, h=64, w=128, dfull=48),
                    train_batch=bench.make_train_batch(b=1, v=3, h=64, w=128, dfull=48),
                    eval_iters=1, train_iters=1)
    line = bench.line(res)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["metric"] == "dtu_eval_depth_maps_per_sec_per_chip"
    assert set(line["extra"]) == {
        "ms_per_map", "eval_mfu_pct", "eval_tflops_per_map", "train_steps_per_sec",
        "train_samples_per_sec", "train_mfu_pct", "train_protocol", "device_kind",
        "peak_tflops", "init_s", "first_call_s", "train_first_call_s", "finite", "backend",
        "power_limit_w"}
    extra = line["extra"]
    assert extra["finite"] is True and extra["backend"] == "cpu" and extra["device_kind"] == "cpu"
    assert extra["eval_mfu_pct"] is extra["train_mfu_pct"] is extra["power_limit_w"] is None
    assert extra["eval_tflops_per_map"] > 0 and extra["train_protocol"] == (
        "B=1 64x128 3views 48d remat fp32")
    assert res["train"]["flops"] > res["eval"]["flops"]


def test_card_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (bench.run, lambda: bench.build(False), lambda: bench.main([]),
                 lambda: profile_eval.main([]), lambda: profile_train.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_unknown_card_raises(monkeypatch):
    """The peak comes from PEAK_FLOPS by the card's name, with no guess."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA GeForce RTX 4090")
    with pytest.raises(ValueError, match="PEAK_FLOPS"):
        bench.run()
    assert bench.peak_flops("NVIDIA H100 80GB HBM3") == 989e12


# kernel names as a CUDA trace gives them
TRACE_NAMES = {
    "void warp_bilinear_vec_kernel<__nv_bfloat16, 64>(__nv_bfloat16 const*, float2 const*)": "warp",
    "void warp_bilinear_scalar_kernel<float>(float const*, float2 const*, float*)": "warp",
    "void warp_bilinear_narrow_kernel<__nv_bfloat16, 3>(...)": "warp",
    "void warp_bilinear_bwd_vec_kernel<32>(float const*, float2 const*, float*)": "warp backward",
    "void warp_bilinear_bwd_scalar_kernel<4>(float const*, float2 const*, float*)":
        "warp backward",
    "void flash_fwd_mma_kernel<64, true>(__nv_bfloat16 const*, ...)": "flash",
    "void flash_fwd_3xtf32_kernel<16>(float const*, ...)": "flash",
    "void flash_bwd_mma_kernel<16>(__nv_bfloat16 const*, ...)": "flash backward",
    "void flash_bwd_3xtf32_kernel<64>(float const*, ...)": "flash backward",
    "void conv2d_mma_kernel<3, 8, 8, false>(__nv_bfloat16 const*, ...)": "conv",
    "void conv2d_tf32_kernel<float, 7, 16, 0, true>(float const*, ...)": "conv",
    "conv2d_pack_tf32_kernel(float const*, long const*, float4*, long, int, int)": "conv",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64":
        "cuDNN convolutions",
    "sm80_xmma_dgrad_implicit_gemm_indexed_f32f32_tf32f32_f32_nhwckrsc_nchw": "cuDNN convolutions",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float>(...)": "cuDNN convolutions",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1":
        "GEMMs",
    "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128_16x3_nn_align4>(...)": "GEMMs",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, ...>>(...)":
        "reductions and softmax",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(...)":
        "reductions and softmax",
    "void (anonymous namespace)::softmax_warp_forward<float, float, float, 9, false>(...)":
        "reductions and softmax",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(...)":
        "copies and transposes",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 4>":
        "copies and transposes",
    "Memcpy HtoD (Pageable -> Device)": "copies and transposes",
    "void at::native::index_elementwise_kernel<128, 4, ...>(...)": "copies and transposes",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>":
        "elementwise",
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>":
        "elementwise",
    "some_other_kernel": "other",
}


@pytest.mark.parametrize("name", list(TRACE_NAMES))
def test_rollup_category(name):
    assert profiler.category(name) == TRACE_NAMES[name]


def test_rollup_puts_every_hand_written_kernel_in_its_family():
    """Each HAND_WRITTEN name, as profile_run matches it (the name up to its
    template arguments), lands in the family that lists it, and rollup sums
    by category over every category."""
    for k in profiler.HAND_WRITTEN:
        family = next(f for f, names in profiler.FAMILIES.items() if k in names)
        assert profiler.category(f"void {k}<64>(float const*)") == family
    kernels = [{"name": n, "ms": 1.0} for n in TRACE_NAMES]
    got = profiler.rollup(kernels)
    assert set(got) == set(profiler.CATEGORIES)
    assert sum(got.values()) == len(TRACE_NAMES)
    assert got["warp"] == 3 and got["conv"] == 3 and got["other"] == 1
