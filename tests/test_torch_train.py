"""The training slice of the PyTorch port against the JAX package, on the
CPU: K3 and K1 with their gradients, train-mode BatchNorm, the schedule,
the clipped AdamW, the hybrid losses, and two whole `make_train_step`
steps from one state carried over by `train_state_from_jax`. Inputs are
made with numpy; every tolerance is stated beside its comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lunaris_orion_tpu.config import TeacherConfig, TrainConfig, VAEConfig
from lunaris_orion_tpu.models import vae as jvae
from lunaris_orion_tpu.ops import layers as jlayers
from lunaris_orion_tpu.ops.pallas.loss_epilogue import mse_kl_pallas
from lunaris_orion_tpu.train import losses as jlosses
from lunaris_orion_tpu.train import schedule as jschedule
from lunaris_orion_tpu.train import state as jstate
from lunaris_orion_tpu.train import step as jstep
from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
from lunaris_orion_tpu_torch.ops import layers
from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as k3
from lunaris_orion_tpu_torch.train import losses, schedule, state, step
from lunaris_orion_tpu_torch.utils.convert import (
    teacher_state_dict_from_jax, train_state_from_jax, vae_state_dict_from_jax)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# --- K3 -------------------------------------------------------------------

def _mse_kl_inputs(seed, shape=(3, 8, 8, 3), latent=16):
    r = np.random.default_rng(seed)
    recon = r.uniform(-1, 1, shape).astype(np.float32)
    x = r.uniform(-1, 1, shape).astype(np.float32)
    mu = r.standard_normal((shape[0], latent)).astype(np.float32)
    lv = (0.5 * r.standard_normal((shape[0], latent))).astype(np.float32)
    return recon, x, mu, lv


def test_mse_kl_plain_matches_pallas():
    ins = _mse_kl_inputs(0)
    want = [float(v) for v in mse_kl_pallas(*map(jnp.asarray, ins))]
    got = [float(v) for v in k3.mse_kl_plain(*_t(*ins))]
    # f32, sums in other orders: rtol 1e-6.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_mse_kl_grads_match_jax():
    ins = _mse_kl_inputs(1)
    want = jax.grad(lambda *a: sum(jlosses._recon_kl_xla(*a)) * 1.0,
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, ins))
    ts = [t.requires_grad_() for t in _t(*ins)]
    out = k3.mse_kl(*ts)
    assert type(out[0].grad_fn).__name__ == "_MseKlBackward"
    sum(out).backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-7,
                                   rtol=1e-6)


# --- K1 gradients, BatchNorm, dropout --------------------------------------

def test_gn_mish_grads_match_jax():
    r = np.random.default_rng(2)
    x = (0.5 + 2 * r.standard_normal((2, 8, 8, 32))).astype(np.float32)
    w = (1 + 0.1 * r.standard_normal(32)).astype(np.float32)
    b = (0.1 * r.standard_normal(32)).astype(np.float32)
    dy = r.standard_normal(x.shape).astype(np.float32)

    def f(x, w, b):
        y = jlayers.group_norm_mish({"scale": w, "bias": b}, x, groups=8)
        return jnp.sum(y * dy)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    ts = [t.requires_grad_() for t in _t(x, w, b)]
    y = k1.gn_mish(*ts, groups=8)
    assert type(y.grad_fn).__name__ == "_GnMishBackward"
    y.backward(torch.from_numpy(dy))
    # f32; the statistics' sums run in other orders: atol 1e-4 (dw, db sum
    # 128 terms of O(1)), rtol 1e-4.
    for name, t, wnt in zip(("dx", "dweight", "dbias"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wnt),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_batch_norm_train_matches_jax():
    r = np.random.default_rng(3)
    x = (1.0 + 2 * r.standard_normal((4, 6, 5, 8))).astype(np.float32)
    p = {"scale": (1 + 0.1 * r.standard_normal(8)).astype(np.float32),
         "bias": (0.1 * r.standard_normal(8)).astype(np.float32)}
    s = {"mean": (0.1 * r.standard_normal(8)).astype(np.float32),
         "var": (1 + r.random(8)).astype(np.float32)}
    want, new = jlayers.batch_norm(jax.tree_util.tree_map(jnp.asarray, p),
                                   jax.tree_util.tree_map(jnp.asarray, s),
                                   jnp.asarray(x), train=True)
    got, mean, var = layers.batch_norm_train(
        *_t(x.transpose(0, 3, 1, 2), s["mean"], s["var"], p["scale"],
            p["bias"]))
    # f32; atol 1e-5 / rtol 1e-5 (batch sums in other orders).
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(new["mean"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(new["var"]),
                               atol=1e-6, rtol=1e-5)


def test_dropout_masks_are_seeded_and_scaled():
    x = torch.ones(4, 16, 5, 5)
    g = lambda: torch.Generator().manual_seed(7)
    a = layers.dropout(x, 0.25, generator=g())
    assert torch.equal(a, layers.dropout(x, 0.25, generator=g()))
    assert set(a.unique().tolist()) == {0.0, float(np.float32(1 / 0.75))}
    c = layers.dropout2d(x, 0.5, generator=g())
    per_channel = c.amax(dim=(2, 3))
    assert torch.equal(c, per_channel[:, :, None, None].expand_as(c))
    assert 0 < (per_channel == 0).sum() < per_channel.numel()
    assert torch.equal(layers.dropout(x, 0.5), x)          # no generator


# --- schedule, optimizer, losses -------------------------------------------

def test_schedule_matches_jax_over_restarts():
    jsched = jschedule.cosine_warm_restarts(1e-4, 10, 1e-6)
    tsched = schedule.cosine_warm_restarts(1e-4, 10, 1e-6)
    steps = np.arange(201)
    want = np.asarray(jax.vmap(jsched)(jnp.asarray(steps)))
    got = np.array([tsched(int(s)) for s in steps])
    # jax evaluates in f32, the port in f64: rtol 1e-6, and atol 1e-11
    # (base_lr x f32 epsilon) where the cosine nears -1 and f32 cancels.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-11)
    for restart in (10, 30, 70, 150):     # each restart returns to base_lr
        assert got[restart] == pytest.approx(1e-4, rel=1e-12)
        assert got[restart - 1] < 0.05 * 1e-4


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])
def test_clipped_adamw_matches_optax(grad_scale):
    """Two updates of one model's optimizer, below and above the clip
    norm (max_grad_norm 1)."""
    cfg = TrainConfig()
    r = np.random.default_rng(4)
    params = {"a": r.standard_normal((3, 4)).astype(np.float32),
              "b": r.standard_normal(5).astype(np.float32)}
    grads = [{k: (grad_scale * r.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    tx = jstate.make_optimizers(cfg)[0]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    opt = state.make_optimizers(cfg, module, torch.nn.Linear(1, 1))[0]
    for count, g in enumerate(grads):
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step(count)
        # The moments are linear in the clipped gradient (the parameters
        # barely see its size at eps 1e-8): exp_avg = mu, exp_avg_sq = nu.
        adam = opt_state[1][0]
        for k, p in module.items():
            s = opt.opt.state[p]
            for name, want in (("exp_avg", adam.mu[k]),
                               ("exp_avg_sq", adam.nu[k])):
                want = np.asarray(want)
                # f32: rtol 1e-5, atol 1e-6 of the largest entry.
                np.testing.assert_allclose(
                    s[name].numpy(), want, rtol=1e-5,
                    atol=1e-6 * np.abs(want).max(), err_msg=f"{k}.{name}")
    for k, p in module.items():
        # f32 Adam in another operation order: atol 1e-7 on O(1) params.
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-7, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("initialized", [False, True])
def test_hybrid_losses_match_jax(initialized):
    r = np.random.default_rng(5)
    quality = r.uniform(0, 1, (4, 4)).astype(np.float32)
    semantic = r.uniform(-1, 1, (4, 1)).astype(np.float32)
    recon_loss, kl_loss = np.float32(0.31), np.float32(0.07)
    w = jlosses.LossWeights()
    jout = jlosses.hybrid_losses(
        recon_loss=jnp.asarray(recon_loss), kl_loss=jnp.asarray(kl_loss),
        quality_scores=jnp.asarray(quality),
        semantic_score=jnp.asarray(semantic), baseline=jnp.float32(0.4),
        baseline_initialized=jnp.asarray(initialized), w=w)
    tout = losses.hybrid_losses(
        recon_loss=torch.tensor(recon_loss), kl_loss=torch.tensor(kl_loss),
        quality_scores=torch.from_numpy(quality),
        semantic_score=torch.from_numpy(semantic),
        baseline=torch.tensor(0.4), baseline_initialized=torch.tensor(initialized),
        w=losses.LossWeights(*w))
    for a, b in zip(tout[:4], jout[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert set(tout[4]) == set(jout[4]) and len(tout[4]) == 12
    for k, v in jout[4].items():
        np.testing.assert_allclose(tout[4][k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


# --- the whole step --------------------------------------------------------

def _tiny(size, dropout_rate=0.0):
    """tests/conftest.py's tiny configs at `size` px."""
    vcfg = VAEConfig(latent_dim=16, image_size=size, base_channels=16)
    tcfg = TeacherConfig(
        num_experts=2, feature_dim=16, extractor_dim=16, extractor_stem=8,
        branch_dim=8, expert_layers=2, intermediate_dim=16, embedding_dim=8,
        num_heads=4, rel_pos_size=4, image_size=size,
        dropout_rate=dropout_rate)
    cfg = TrainConfig(batch_size=2, gradient_accumulation_steps=2,
                      image_size=size, latent_dim=16, embedding_dim=8,
                      feature_dim=16, num_experts=2)
    return cfg, vcfg, tcfg


def _fixed_eps(monkeypatch, eps):
    """One eps for every micro-step in both packages (the JAX step traces
    its micro-step once, under lax.scan)."""
    def jax_rep(rng, mu, logvar):
        std = jnp.exp(0.5 * logvar.astype(jnp.float32))
        return (mu.astype(jnp.float32) + jnp.asarray(eps) * std).astype(mu.dtype)

    def port_rep(mu, logvar, generator=None):
        std = torch.exp(0.5 * logvar.float())
        return (mu.float() + torch.from_numpy(eps) * std).to(mu.dtype)
    monkeypatch.setattr(jvae, "reparameterize", jax_rep)
    monkeypatch.setattr(LunarisCoreVAE, "reparameterize",
                        staticmethod(port_rep))


def _rounding_noise_only(key, shape, vcfg):
    """Entries whose gradient is zero in exact arithmetic, so that Adam
    moves them by the sign of rounding noise, in either package: the key
    third of each attention qkv bias (a constant added to all of a query's
    scores cancels in the softmax), and the bias of the VAE's last ConvT
    when its GroupNorm holds one channel per group."""
    mask = np.zeros(shape, bool)
    if key.endswith("attention.qkv.bias"):
        c = shape[0] // 3
        mask[c:2 * c] = True
    if (key == f"decoder.up{vcfg.num_down}.0.bias"
            and max(vcfg.base_channels // 2, vcfg.gn_groups) == vcfg.gn_groups):
        mask[:] = True
    return mask


def test_train_step_matches_jax(monkeypatch):
    """Two optimizer steps of make_train_step, A = 2 micro-batches of 2 at
    48 px (N = 2304: K2's plain versions in the port, the XLA flash path in
    JAX), teacher dropout 0, one fixed eps, remat on, from one JAX state."""
    cfg, vcfg, tcfg = _tiny(48)
    eps = np.random.default_rng(6).standard_normal((2, 16)).astype(np.float32)
    _fixed_eps(monkeypatch, eps)
    js = jstate.create_state(jax.random.PRNGKey(0), cfg, vcfg, tcfg)
    ts = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js), cfg,
                              vcfg, tcfg)
    jfn = jax.jit(jstep.make_train_step(cfg, vcfg, tcfg))
    tfn = step.make_train_step(cfg)
    r = np.random.default_rng(7)
    for _ in range(2):
        images = r.integers(0, 256, (2, 2, 48, 48, 3), dtype=np.uint8)
        js, jm = jfn(js, jnp.asarray(images))
        ts, tm = tfn(ts, torch.from_numpy(images))
        assert set(tm) == set(jm)
        for k, v in jm.items():
            # f32 scalars after ~40 layers: atol 1e-5 / rtol 1e-4.
            np.testing.assert_allclose(float(tm[k]), float(v), atol=1e-5,
                                       rtol=1e-4, err_msg=k)
    assert ts.step == int(js.step) == 2
    assert float(ts.baseline) == pytest.approx(float(js.baseline), abs=1e-6)
    assert bool(ts.baseline_initialized) and bool(js.baseline_initialized)
    js = jax.tree_util.tree_map(np.asarray, js)
    for name, model, want in (
            ("vae", ts.vae, vae_state_dict_from_jax(js.vae_params, vcfg)),
            ("teacher", ts.teacher, teacher_state_dict_from_jax(
                js.teacher_params, js.teacher_stats, tcfg))):
        got = model.state_dict()
        assert set(got) == set(want), name
        for k, w in want.items():
            if k.endswith(("num_batches_tracked", "last_spatial_shapes")):
                continue
            # params after two AdamW steps (lr 1e-4) and BatchNorm running
            # statistics (2 steps x 2 micro-batches x 2 calls): f32,
            # atol 1e-5 / rtol 1e-4. Entries moved by rounding noise only:
            # within two steps' reach, 2 x 2 lr.
            noise = _rounding_noise_only(k, w.shape, vcfg)
            a, b = got[k].numpy(), w.numpy()
            np.testing.assert_allclose(a[~noise], b[~noise], atol=1e-5,
                                       rtol=1e-4, err_msg=f"{name}.{k}")
            np.testing.assert_allclose(a[noise], b[noise], atol=4e-4, rtol=0,
                                       err_msg=f"{name}.{k}")

    # AdamW's moments against optax's mu and nu: linear (and quadratic) in
    # the averaged, clipped gradients, so they hold the division by A and
    # the clip, which the parameters (moved by ~lr x sign) barely show.
    for name, model, opt, tree, to_sd in (
            ("vae", ts.vae, ts.vae_opt, js.vae_opt,
             lambda t: vae_state_dict_from_jax(t, vcfg)),
            ("teacher", ts.teacher, ts.teacher_opt, js.teacher_opt,
             lambda t: teacher_state_dict_from_jax(t, js.teacher_stats, tcfg))):
        adam = tree[1][0]
        assert int(adam.count) == 2
        for moment, want_sd in (("exp_avg", to_sd(adam.mu)),
                                ("exp_avg_sq", to_sd(adam.nu))):
            top = max(np.abs(want_sd[k].numpy()).max()
                      for k, _ in model.named_parameters())
            for k, p in model.named_parameters():
                s = opt.opt.state[p]
                assert float(s["step"]) == 2.0
                a, b = s[moment].numpy(), want_sd[k].numpy()
                noise = _rounding_noise_only(k, b.shape, vcfg)
                # f32 gradients through ~40 layers, two steps: rtol 1e-3,
                # atol 1e-5 of the model's largest entry (a gradient not
                # divided by A would be off by half of itself). Entries
                # zero in exact arithmetic are rounding noise in both
                # packages and are not compared.
                np.testing.assert_allclose(
                    a[~noise], b[~noise], rtol=1e-3, atol=1e-5 * top,
                    err_msg=f"{name}.{k}.{moment}")


def test_remat_does_not_change_the_gradients():
    """With dropout on (rate 0.1 everywhere, K2's hash on the flash path at
    48 px), remat replays each expert block with the seeds drawn before it:
    the same gradients, and the running statistics advance once."""
    cfg, vcfg, tcfg = _tiny(48, dropout_rate=0.1)
    images = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (1, 2, 48, 48, 3), dtype=np.uint8))
    grads, stats = [], []
    for remat in (True, False):
        st = state.create_state(cfg, "cpu", 3, vcfg, tcfg)
        step.make_train_step(cfg, remat=remat)(st, images)
        grads.append([p.grad.clone() for p in st.teacher.parameters()]
                     + [p.grad.clone() for p in st.vae.parameters()])
        stats.append({k: v.clone() for k, v in st.teacher.state_dict().items()
                      if "running" in k or "num_batches" in k})
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    for k in stats[0]:
        torch.testing.assert_close(stats[0][k], stats[1][k], atol=0, rtol=0)
    assert int(stats[0]["experts.0.0.conv1.2.num_batches_tracked"]) == 2


def test_eval_step_matches_jax(monkeypatch):
    cfg, vcfg, tcfg = _tiny(32)
    js = jstate.create_state(jax.random.PRNGKey(1), cfg, vcfg, tcfg)
    ts = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js), cfg,
                              vcfg, tcfg)
    images = np.random.default_rng(9).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    want = jax.jit(jstep.make_eval_step(cfg, vcfg, tcfg))(js, jnp.asarray(images))
    got = step.make_eval_step(cfg)(ts, torch.from_numpy(images))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_state_conversion_carries_the_optimizer():
    """train_state_from_jax maps Adam's mu, nu and count onto AdamW's
    exp_avg, exp_avg_sq and step, laid out as the parameters."""
    cfg, vcfg, tcfg = _tiny(32)
    js = jax.tree_util.tree_map(np.asarray, jstate.create_state(
        jax.random.PRNGKey(2), cfg, vcfg, tcfg))
    r = np.random.default_rng(10)
    adam = js.vae_opt[1][0]
    mu = jax.tree_util.tree_map(lambda x: r.standard_normal(x.shape).astype(
        np.float32), adam.mu)
    js = js.replace(vae_opt=(js.vae_opt[0], (adam._replace(
        mu=mu, count=np.int32(5)),) + tuple(js.vae_opt[1][1:])),
        step=np.int32(5), baseline=np.float32(0.25),
        baseline_initialized=np.bool_(True))
    ts = train_state_from_jax(js, cfg, vcfg, tcfg)
    want = vae_state_dict_from_jax(mu, vcfg)
    for name, p in ts.vae.named_parameters():
        s = ts.vae_opt.opt.state[p]
        assert float(s["step"]) == 5.0
        torch.testing.assert_close(s["exp_avg"], want[name], atol=0, rtol=0)
    assert ts.step == 5 and float(ts.baseline) == 0.25
    assert bool(ts.baseline_initialized)


def test_options_without_a_port_raise():
    cfg, _, _ = _tiny(32)
    for kw in (dict(fuse_teacher=True), dict(cached_prompt_embeddings=True),
               dict(bf16_momentum=True), dict(attn_window=256)):
        with pytest.raises(NotImplementedError):
            step.make_train_step(cfg.replace(**kw))
    with pytest.raises(NotImplementedError):
        step.make_train_step(cfg, cp_mesh=object(), cp_axis="model")
    with pytest.raises(NotImplementedError):
        step.make_embed_step(cfg)


def test_normalize_images_matches_jax():
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jstep.normalize_images(jnp.asarray(x), jd).astype(
            jnp.float32))
        got = step.normalize_images(torch.from_numpy(x), td).float().numpy()
        np.testing.assert_array_equal(got, want)
