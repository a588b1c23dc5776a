"""The pieces of the port's training slice against the JAX package, on the
CPU in fp32: K1's gradient, train-mode BatchNorm, the schedule and
optimizer, the color jitter, and the port's train step with ``remat``,
``device_augment`` and ``accum_steps`` against its plain form. The whole
train and stereo steps are in ``test_torch_train_step.py``.

The inputs have no exact ties. JAX and torch differ there by design, and
the port keeps torch's rule: at a clip bound JAX's gradient is 0.5 and
torch's 1, and at a ``min`` tie JAX splits the gradient where torch gives
it to one index.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_visual_slam_tpu.ops import photometric as jphoto
from deep_visual_slam_tpu.ops.pallas.photometric_pallas import reprojection_loss_fused
from deep_visual_slam_tpu.training import augment as jaugment
from deep_visual_slam_tpu.training import state as jstate

from deep_visual_slam_torch.data import synthetic_vo_batch
from deep_visual_slam_torch.models.resnet import BatchNorm2d, frozen_running_stats
from deep_visual_slam_torch.ops import photometric_cuda
from deep_visual_slam_torch.training import (
    TrainState,
    VOLossConfig,
    augment,
    init_vo_models,
    make_optimizer,
    make_vo_train_step,
    polynomial_lr,
)

# One thread per test process: the tests run beside others, and torch's
# default of one thread per core then spends its time waiting for cores.
torch.set_num_threads(1)

RATIO = 0.85


def _maps(rng, shape):
    """pred, target in [0, 1) and dL/dout in [0.5, 1.5), float32 numpy."""
    x = rng.uniform(size=shape).astype(np.float32)
    y = rng.uniform(size=shape).astype(np.float32)
    g = rng.uniform(0.5, 1.5, size=shape[:3] + (1,)).astype(np.float32)
    return x, y, g


@pytest.mark.parametrize("shape", [(2, 64, 96, 3), (2, 37, 53, 3)])
def test_reprojection_grad_cpu_matches_jax(rng, shape):
    """dL/dpred and dL/dtarget of the CPU path (plain version, torch
    autograd) against ``jax.vjp`` of the XLA formula and of the Pallas
    kernel in interpret mode (whose backward is that XLA VJP). Both are
    fp32 with sums in other orders: atol 2e-5 x the largest gradient."""
    x, y, g = _maps(rng, shape)
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    photometric_cuda.reprojection_loss(tx, ty, RATIO).backward(torch.from_numpy(g))
    for fn in (
        jphoto.reprojection_loss,
        functools.partial(reprojection_loss_fused, interpret=True),
    ):
        _, vjp = jax.vjp(lambda p, t: fn(p, t, RATIO), jnp.asarray(x), jnp.asarray(y))
        for got, want in zip((tx.grad, ty.grad), vjp(jnp.asarray(g))):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max()
            )


def _fill_index(i, n):
    """The kernel's halo rule: the reflection for i in [-1, n], beyond it
    (read only for pixels outside the image) clamped into the image."""
    r = torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))
    return r.clamp(0, n - 1)


def _multiplicity(p, q, n):
    """Taps of neighbour p's reflect-padded window that land on q, per axis."""
    return 1.0 + ((p == 0) & (q == 1)) + ((p == n - 1) & (q == n - 2))


def _gather_backward(x, y, g, ratio, tile=(3, 4)):
    """The CUDA backward kernel's formulation (``csrc/reprojection.cu``)
    written in torch, tile by tile at a small tile of TH x TW outputs: the
    tile's pred and target with a 2-pixel halo filled by the kernel's halo
    rule; the coefficients of the window sums of every pixel of the tile
    plus a 1-pixel halo, 0 outside the image; their gather onto the tile's
    pixels with the reflect padding's multiplicities at the image's edges.
    The kernel itself runs only on the card (``tests/test_torch_kernels.py``);
    this checks its algebra and its tiling here."""
    B, H, W, C = x.shape
    TH, TW = tile
    grad = torch.empty_like(x)
    for y0 in range(0, H, TH):
        for x0 in range(0, W, TW):
            iy = _fill_index(torch.arange(y0 - 2, y0 + TH + 2), H)
            ix = _fill_index(torch.arange(x0 - 2, x0 + TW + 2), W)
            xt, yt = (a.index_select(1, iy).index_select(2, ix) for a in (x, y))

            def window_sum(a):  # [B, TH+4, TW+4, C] -> [B, TH+2, TW+2, C]
                return sum(a[:, i : i + TH + 2, j : j + TW + 2]
                           for i in range(3) for j in range(3))

            mu_x, mu_y = window_sum(xt) / 9.0, window_sum(yt) / 9.0
            sigma_x = window_sum(xt * xt) / 9.0 - mu_x * mu_x
            sigma_y = window_sum(yt * yt) / 9.0 - mu_y * mu_y
            sigma_xy = window_sum(xt * yt) / 9.0 - mu_x * mu_y
            a1, a2 = 2.0 * mu_x * mu_y + 0.01**2, 2.0 * sigma_xy + 0.03**2
            b1, b2 = mu_x * mu_x + mu_y * mu_y + 0.01**2, sigma_x + sigma_y + 0.03**2
            n, d = a1 * a2, b1 * b2
            u = (1.0 - n / d) * 0.5
            py = torch.arange(y0 - 1, y0 + TH + 1)
            px = torch.arange(x0 - 1, x0 + TW + 1)
            inside = (((py >= 0) & (py < H))[:, None, None]
                      & ((px >= 0) & (px < W))[None, :, None])
            gp = g.index_select(1, py.clamp(0, H - 1)).index_select(2, px.clamp(0, W - 1))
            g_u = gp * ratio / C * ((u >= 0) & (u <= 1)) * inside
            h9 = g_u * (0.5 / 9.0) / d
            g_n2, g_d = -2.0 * h9, h9 * (n / d)  # 2 dL/dn / 9, dL/dd / 9
            coef = [mu_y * g_n2 * (a2 - a1) + 2.0 * mu_x * g_d * (b2 - b1),
                    g_d * b1, g_n2 * a1]

            qy, qx = torch.arange(y0, y0 + TH), torch.arange(x0, x0 + TW)
            sums = [sum(
                _multiplicity(qy + i - 1, qy, H)[:, None, None]
                * _multiplicity(qx + j - 1, qx, W)[None, :, None]
                * k[:, i : i + TH, j : j + TW]
                for i in range(3) for j in range(3)
            ) for k in coef]
            xq, yq = xt[:, 2 : TH + 2, 2 : TW + 2], yt[:, 2 : TH + 2, 2 : TW + 2]
            gq = gp[:, 1 : TH + 1, 1 : TW + 1]
            dx = (sums[0] + 2.0 * xq * sums[1] + yq * sums[2]
                  - gq * (1.0 - ratio) / C * torch.sign(yq - xq))
            h, w = min(TH, H - y0), min(TW, W - x0)
            grad[:, y0 : y0 + h, x0 : x0 + w] = dx[:, :h, :w]
    return grad


def test_grad_view_passes_uniform_strides_uncopied():
    """The backward kernel takes dL/dout as a pointer and a pixel stride:
    the VO loss's stride-2 slice and an expanded gradient (stride 0) pass
    as they are; a view with other strides is copied contiguous."""
    x = torch.zeros(2, 5, 7, 3)
    both = torch.rand(2, 5, 7, 2)
    for g, stride in ((both[..., 1:], 2), (torch.ones(()).expand(2, 5, 7, 1), 0),
                      (both[..., :1].contiguous(), 1)):
        view, s = photometric_cuda._grad_view(g, x)
        assert s == stride and view.data_ptr() == g.data_ptr()
    g = torch.rand(2, 7, 5, 1).transpose(1, 2)
    view, s = photometric_cuda._grad_view(g, x)
    assert s == 1 and view.is_contiguous() and torch.equal(view, g)
    with pytest.raises(ValueError):
        photometric_cuda._grad_view(both, x)


@pytest.mark.parametrize("wrt", ["pred", "both"])
@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 2, 5, 3), (2, 7, 9, 1)])
def test_autograd_function_with_kernel_algebra(monkeypatch, rng, shape, wrt):
    """``_ReprojectionLoss`` (the CUDA path's autograd Function) with its two
    launches replaced by the plain forward and :func:`_gather_backward`,
    against the plain version's autograd. The maps are concatenated on the
    last axis and min-reduced as in the VO loss, so the incoming gradient is
    a stride-2 slice (the card tests hold the kernel to such a gradient);
    the backward launches once per input that requires grad in each map,
    with pred and target swapped for the target. Both are
    fp32 with sums in other orders: atol 2e-5 x the largest gradient."""
    calls = []
    monkeypatch.setattr(
        photometric_cuda, "_forward_kernel", photometric_cuda.reprojection_loss_plain
    )

    def backward(pred, target, g, ratio):
        assert g.shape == pred.shape[:3] + (1,)
        calls.append(pred)
        return _gather_backward(pred, target, g, ratio)

    monkeypatch.setattr(photometric_cuda, "reprojection_loss_backward", backward)
    a, b, t = (rng.uniform(size=shape).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.5, 1.5, size=shape[:3] + (1,)).astype(np.float32)
    grads = []
    for fn in (photometric_cuda._ReprojectionLoss.apply,
               photometric_cuda.reprojection_loss_plain):
        ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b)
        tt = torch.from_numpy(t).requires_grad_(wrt == "both")
        both = torch.cat([fn(ta, tt, RATIO), fn(tb, tt, RATIO)], dim=-1)
        (both.min(dim=-1, keepdim=True).values * torch.from_numpy(w)).sum().backward()
        grads.append((ta.grad, tt.grad))
    assert len(calls) == (3 if wrt == "both" else 1)  # a: pred; target twice
    for got, want in zip(*grads):
        if want is None:
            assert got is None
            continue
        torch.testing.assert_close(
            got, want, rtol=0, atol=2e-5 * want.abs().max().item()
        )


def test_batchnorm_train_matches_flax(rng):
    """Train-mode output and running statistics against flax's BatchNorm
    (momentum 0.9, biased variance), over two updates; ``nn.BatchNorm2d``
    would move ``running_var`` toward the variance times n/(n-1) = 120/119.
    Within :func:`frozen_running_stats` the output is the same and the
    statistics stay. fp32 reductions in other orders: atol 1e-5."""
    C = 8
    scale, bias = rng.uniform(0.5, 1.5, C), rng.uniform(-0.2, 0.2, C)
    mean, var = rng.uniform(-0.2, 0.2, C), rng.uniform(0.5, 1.5, C)
    variables = {
        "params": {"scale": scale, "bias": bias},
        "batch_stats": {"mean": mean, "var": var},
    }
    variables = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), variables)
    bn = BatchNorm2d(C)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias),
                        ("running_mean", mean), ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    bn.train()
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    for _ in range(2):
        x = (rng.normal(size=(4, 6, 5, C)) * 2.0 + 0.5).astype(np.float32)
        want, updates = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], **updates}
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, ours).numpy(), updates["batch_stats"][theirs],
                atol=1e-5, rtol=0, err_msg=ours,
            )
    assert bn.num_batches_tracked.item() == 2
    stats = (bn.running_mean.clone(), bn.running_var.clone())
    with frozen_running_stats(bn):
        again = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    torch.testing.assert_close((bn.running_mean, bn.running_var), stats, rtol=0, atol=0)
    assert bn.num_batches_tracked.item() == 2


def test_polynomial_lr_matches_optax():
    for init, total, power, end in ((1e-4, 10, 0.9, 0.0), (1e-3, 7, 2.0, 1e-5),
                                    (1e-3, 0, 0.9, 0.0)):
        ours = polynomial_lr(init, total, power, end)
        theirs = jstate.polynomial_lr(init, total, power, end)
        for t in range(total + 3):
            np.testing.assert_allclose(ours(t), float(theirs(t)), rtol=1e-6, err_msg=t)


@pytest.mark.parametrize(
    "weight_decay, max_grad_norm", [(0.0, None), (1e-2, None), (0.0, 0.5)],
    ids=["adam", "adamw", "clipped"],
)
def test_optimizer_matches_optax(rng, weight_decay, max_grad_norm):
    """Three updates of ``TrainState.apply_gradients`` against the JAX
    package's ``make_optimizer`` (optax), with the schedule, on random
    parameters and gradients; the returned norm is the gradient's before
    clipping. fp32 in other orders: rtol 1e-5, atol 1e-8."""
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    state = TrainState(
        None, None, make_optimizer(tparams, 1e-3, 0.8, weight_decay),
        polynomial_lr(1e-3, 5), max_grad_norm,
    )
    tx = jstate.make_optimizer(
        1e-3, 5, beta1=0.8, weight_decay=weight_decay, max_grad_norm=max_grad_norm
    )
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    for _ in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = state.apply_gradients()
        jgrads = [jnp.asarray(g) for g in grads]
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(jgrads)), rtol=1e-6)
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, jp in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), jp, rtol=1e-5, atol=1e-8)
    assert state.step == 3


def test_hsv_matches_jax(rng):
    rgb = rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)
    rgb[0, 0, :3] = [[0.2, 0.2, 0.2], [0.0, 0.0, 0.0], [0.7, 0.7, 0.1]]  # c = 0, ties
    hsv = augment.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(
        hsv.numpy(), jaugment.rgb_to_hsv(jnp.asarray(rgb)), rtol=1e-5, atol=1e-4
    )
    back = augment.hsv_to_rgb(hsv)
    np.testing.assert_allclose(
        back.numpy(), jaugment.hsv_to_rgb(jnp.asarray(hsv.numpy())), atol=1e-5
    )
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-5)


def test_color_jitter_matches_jax(rng):
    """``apply_color_jitter`` on two snippets of three frames, each with its
    own factors (the second with no hue shift), against the JAX function
    applied to each snippet. fp32: atol 1e-5."""
    frames = rng.uniform(size=(2, 3, 12, 16, 3)).astype(np.float32)
    factors = np.array([[1.2, 0.8, 1.1, 0.13], [0.9, 1.25, 0.75, 0.0]], np.float32)
    got = augment.apply_color_jitter(
        torch.from_numpy(frames), *torch.from_numpy(factors).T
    )
    for i in range(2):
        want = jaugment.apply_color_jitter(jnp.asarray(frames[i]), *factors[i])
        np.testing.assert_allclose(got[i].numpy(), want, atol=1e-5, err_msg=i)


def test_snippet_jitter_is_one_draw_per_snippet():
    """Each snippet's three frames take one set of factors: equal frames stay
    equal, and exactly the gated snippets change; the draws come from the
    generator alone."""
    batch, _ = synthetic_vo_batch(0, 8, 12, 16, device="cpu")
    batch["source_left"] = batch["source_right"] = batch["target_image"]
    outs = [augment.batch_snippet_jitter(batch, torch.Generator().manual_seed(3))
            for _ in range(2)]
    gate = augment.draw_jitter_factors(8, torch.Generator().manual_seed(3))[0]
    assert 0 < gate.sum() < 8
    for k in ("source_left", "target_image", "source_right"):
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)
        torch.testing.assert_close(outs[0][k], outs[0]["target_image"], rtol=0, atol=0)
    changed = (outs[0]["target_image"] != batch["target_image"]).flatten(1).any(1)
    assert torch.equal(changed, gate)


def test_snippet_jitter_outputs_are_contiguous():
    """The jittered frames feed kernel K1 on the card, which takes
    contiguous NHWC images only."""
    batch, _ = synthetic_vo_batch(0, 2, 12, 16, device="cpu")
    out = augment.batch_snippet_jitter(batch, torch.Generator().manual_seed(3))
    for k in ("source_left", "target_image", "source_right"):
        assert out[k].is_contiguous(), k


def test_remat_matches_plain_and_moves_batchnorm_once():
    """``remat=True`` (checkpointed DepthNet) gives the plain step's losses
    and updated weights, and its BatchNorm statistics move once per step,
    not again in the recomputation."""
    cfg = VOLossConfig()
    batch, _ = synthetic_vo_batch(1, 2, 64, 96, device="cpu")
    noise = [torch.randn(2, 64, 96, 2, generator=torch.Generator().manual_seed(s))
             for s in range(4)]
    results = []
    for remat in (False, True):
        depth, pose = init_vo_models(0)
        state = TrainState.create(depth, pose, 1e-4, 10)
        step = make_vo_train_step(depth, pose, cfg, torch.float32, remat=remat, device="cpu")
        losses = step(state, batch, noise=noise)
        results.append((losses, depth.state_dict()))
        assert all(
            m.num_batches_tracked.item() == 1
            for m in depth.modules() if isinstance(m, BatchNorm2d)
        )
    (plain, plain_sd), (remat, remat_sd) = results
    torch.testing.assert_close(remat, plain, rtol=1e-6, atol=0)
    torch.testing.assert_close(remat_sd, plain_sd, rtol=1e-6, atol=1e-7)


def _vo_step(batch, noise, generator=None, **options):
    """One fp32 train step on the CPU from the seed-0 weights: its losses
    and the models it updated."""
    depth, pose = init_vo_models(0)
    state = TrainState.create(depth, pose, 1e-4, 10)
    step = make_vo_train_step(depth, pose, VOLossConfig(), torch.float32,
                              device="cpu", **options)
    return step(state, batch, generator=generator, noise=noise), depth, pose


def test_device_augment_jitters_with_the_generators_draws():
    """``device_augment=True`` color-jitters the snippet inside the step with
    factors drawn from ``generator`` alone (the tie-break noise is handed
    in): the step equals the plain step on the batch jittered beforehand
    from a generator of the same seed, and differs from the plain step on
    the batch as it was."""
    batch, _ = synthetic_vo_batch(1, 2, 64, 96, device="cpu")
    noise = [torch.randn(2, 64, 96, 2, generator=torch.Generator().manual_seed(s))
             for s in range(4)]
    seed = 0  # jitters the first snippet only
    gate = augment.draw_jitter_factors(2, torch.Generator().manual_seed(seed))[0]
    assert gate.tolist() == [True, False]
    inside, _, _ = _vo_step(batch, noise, torch.Generator().manual_seed(seed),
                            device_augment=True)
    assert all(bool(torch.isfinite(v)) for v in inside.values())
    jittered = augment.batch_snippet_jitter(batch, torch.Generator().manual_seed(seed))
    outside, _, _ = _vo_step(jittered, noise)
    torch.testing.assert_close(inside, outside, rtol=0, atol=0)
    raw, _, _ = _vo_step(batch, noise)
    assert raw["loss"] != inside["loss"]


def test_accum_steps_averages_the_microbatch_gradients():
    """``accum_steps=2`` on four rows: its losses and gradient are the mean
    of two plain steps' on rows 0-1 and 2-3 from the same weights (the same
    work in the same order, halved: to the last bits), and every BatchNorm
    moves its statistics once per microbatch."""
    batch, _ = synthetic_vo_batch(2, 4, 64, 96, device="cpu")
    noise = [torch.randn(4, 64, 96, 2, generator=torch.Generator().manual_seed(s))
             for s in range(4)]
    losses, depth, pose = _vo_step(batch, noise, accum_steps=2)
    halves = [
        _vo_step({k: v[rows] for k, v in batch.items()}, [n[rows] for n in noise])
        for rows in (slice(0, 2), slice(2, 4))
    ]
    for k, v in losses.items():
        if k != "grad_norm":
            torch.testing.assert_close(
                v, (halves[0][0][k] + halves[1][0][k]) / 2, rtol=1e-6, atol=0, msg=k
            )
    for i, model in enumerate((depth, pose)):
        for (k, p), (_, p0), (_, p1) in zip(
            model.named_parameters(), halves[0][i + 1].named_parameters(),
            halves[1][i + 1].named_parameters(),
        ):
            torch.testing.assert_close(
                p.grad, (p0.grad + p1.grad) / 2, rtol=1e-6, atol=1e-9, msg=k
            )
        assert all(m.num_batches_tracked.item() == 2
                   for m in model.modules() if isinstance(m, BatchNorm2d))
