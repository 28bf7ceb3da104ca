"""The serving slice of the PyTorch port against the JAX package: weights
made by `vae.init` / `teacher.init`, converted with
lunaris_orion_tpu_torch/utils/convert.py, and the same inputs on both
sides. Run at 32 px (every attention on the full path) and at 48 px
(N = 2304 tokens: K2's plain version in the port, the XLA flash path in
JAX)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lunaris_orion_tpu.config import TeacherConfig, VAEConfig
from lunaris_orion_tpu.models import teacher as jteacher
from lunaris_orion_tpu.models import vae as jvae
from lunaris_orion_tpu.utils import torch_compat as tc
from lunaris_orion_tpu_torch.models import teacher as tteacher
from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
from lunaris_orion_tpu_torch.utils.convert import (
    teacher_state_dict_from_jax, vae_state_dict_from_jax)


def _cfgs(size):
    vcfg = VAEConfig(latent_dim=16, image_size=size, base_channels=16)
    # head_dim = 16 / 2 = 8; extractor 24 -> feature 16 gives every
    # expert's first block a shortcut.
    tcfg = TeacherConfig(
        num_experts=2, feature_dim=16, extractor_dim=24, extractor_stem=8,
        branch_dim=8, expert_layers=2, intermediate_dim=16, embedding_dim=8,
        num_heads=2, rel_pos_size=4, image_size=size)
    return vcfg, tcfg


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_stats(stats, seed):
    """Non-trivial BN running statistics, so their conversion matters."""
    r = np.random.default_rng(seed)

    def f(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['mean']"):
            return (0.2 * r.standard_normal(x.shape)).astype(np.float32)
        return (0.5 + r.random(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, stats)


@pytest.fixture(scope="module", params=[32, 48])
def pair(request):
    size = request.param
    vcfg, tcfg = _cfgs(size)
    kv, kt = jax.random.split(jax.random.PRNGKey(size))
    vp = _numpy(jvae.init(kv, vcfg))
    tp, ts = jteacher.init(kt, tcfg)
    tp, ts = _numpy(tp), _randomize_stats(_numpy(ts), size)
    vae = LunarisCoreVAE(vcfg).eval()
    vae.load_state_dict(vae_state_dict_from_jax(vp, vcfg), strict=True)
    teacher = LunarMoETeacher(tcfg).eval()
    teacher.load_state_dict(teacher_state_dict_from_jax(tp, ts, tcfg),
                            strict=True)
    return dict(size=size, vcfg=vcfg, tcfg=tcfg, vp=vp, tp=tp, ts=ts,
                vae=vae, teacher=teacher)


def test_converters_match_torch_compat_bit_for_bit(pair):
    ours = vae_state_dict_from_jax(pair["vp"], pair["vcfg"])
    ref = tc.vae_state_dict_to_torch(pair["vp"], pair["vcfg"])
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    ours = teacher_state_dict_from_jax(pair["tp"], pair["ts"], pair["tcfg"])
    ref = tc.teacher_state_dict_to_torch(pair["tp"], pair["ts"], pair["tcfg"])
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].shape == np.shape(ref[k]), k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_prior_decode_matches(pair):
    z = np.random.default_rng(1).standard_normal(
        (3, pair["vcfg"].latent_dim)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, z: jvae.decode(
        p["decoder"], z, [], pair["vcfg"]))(pair["vp"], z))
    with torch.no_grad():
        got = pair["vae"].decode(torch.from_numpy(z))
    assert got.shape == want.shape == (3, pair["size"], pair["size"], 3)
    # the per-pixel decode bar of tests/test_torch_parity.py: 1/255
    np.testing.assert_allclose(got.numpy(), want, atol=1.0 / 255.0, rtol=0)


def test_encode_and_forward_match(pair):
    """The encoder (off the serving path) and the deterministic forward:
    mu/logvar at the bar of tests/test_torch_parity.py, recon at 1/255."""
    x = np.random.default_rng(2).uniform(
        -1, 1, (2, pair["size"], pair["size"], 3)).astype(np.float32)
    rec, mu, lv = jax.jit(lambda p, x: jvae.apply(
        p, x, rng=None, cfg=pair["vcfg"], sample_posterior=False))(
        pair["vp"], x)
    with torch.no_grad():
        t_rec, t_mu, t_lv = pair["vae"](torch.from_numpy(x),
                                        sample_posterior=False)
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(mu), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(t_lv.numpy(), np.asarray(lv), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(t_rec.numpy(), np.asarray(rec),
                               atol=1.0 / 255.0, rtol=0)


def test_teacher_scores_match(pair):
    """JAX-decoded sprites scored by both teachers: quality and gate at the
    bar of tests/test_teacher_interop.py (atol 1e-4, rtol 1e-3), the
    embeddings at its 1e-3."""
    z = np.random.default_rng(3).standard_normal(
        (2, pair["vcfg"].latent_dim)).astype(np.float32)
    imgs = jvae.decode(pair["vp"]["decoder"], jnp.asarray(z), [], pair["vcfg"])
    want, _ = jax.jit(lambda p, s, x: jteacher.apply(
        p, s, x, cfg=pair["tcfg"], train=False))(pair["tp"], pair["ts"], imgs)
    with torch.no_grad():
        got = tteacher.apply(pair["teacher"], torch.from_numpy(np.array(imgs)))
    for key, atol in (("quality_scores", 1e-4), ("expert_weights", 1e-4),
                      ("semantic_score", 1e-4), ("style_embedding", 1e-3),
                      ("prompt_embedding", 1e-3)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, rtol=1e-3, err_msg=key)


def test_semantic_score_conditions_on_the_given_prompt(pair):
    x = np.random.default_rng(4).uniform(
        -1, 1, (2, pair["size"], pair["size"], 3)).astype(np.float32)
    e = np.random.default_rng(5).standard_normal(
        (2, pair["tcfg"].embedding_dim)).astype(np.float32)
    want, _ = jteacher.apply(pair["tp"], pair["ts"], jnp.asarray(x),
                             cfg=pair["tcfg"], prompt_embedding=jnp.asarray(e),
                             train=False, attn_impl="full")
    with torch.no_grad():
        got = pair["teacher"](torch.from_numpy(x), torch.from_numpy(e))
    np.testing.assert_allclose(got["semantic_score"].numpy(),
                               np.asarray(want["semantic_score"]),
                               atol=1e-4, rtol=1e-3)


def test_sample_and_reparameterize_are_seeded(pair):
    """sample() decodes N(0, I) * temperature from the given generator;
    reparameterize() draws its eps from the given generator in f32."""
    vae, latent = pair["vae"], pair["vcfg"].latent_dim
    with torch.no_grad():
        a = vae.sample(2, torch.Generator().manual_seed(7), temperature=0.5)
        z = torch.randn(2, latent, generator=torch.Generator().manual_seed(7))
        torch.testing.assert_close(a, vae.decode(z * 0.5), atol=0, rtol=0)
        mu, logvar = torch.zeros(3, latent), torch.full((3, latent), -2.0)
        r1 = vae.reparameterize(mu, logvar, torch.Generator().manual_seed(1))
        eps = torch.randn(3, latent, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(r1, eps * np.exp(-1.0), atol=1e-7, rtol=0)


def test_teacher_train_mode_matches(pair):
    """Train mode without dropout (no generator; JAX: rng=None): batch
    statistics in every BatchNorm, the running statistics advanced once,
    remat on. Outputs at the bar of test_teacher_scores_match; the new
    running statistics at atol 1e-5 / rtol 1e-4 (f32 batch sums)."""
    x = np.random.default_rng(6).uniform(
        -1, 1, (3, pair["size"], pair["size"], 3)).astype(np.float32)
    e = np.random.default_rng(7).standard_normal(
        (3, pair["tcfg"].embedding_dim)).astype(np.float32)
    want, new_stats = jax.jit(lambda p, s, x, e: jteacher.apply(
        p, s, x, cfg=pair["tcfg"], prompt_embedding=e, train=True))(
        pair["tp"], pair["ts"], x, e)
    teacher = copy.deepcopy(pair["teacher"])
    got = tteacher.apply(teacher, torch.from_numpy(x), train=True,
                         prompt_embedding=torch.from_numpy(e))
    for key, atol in (("quality_scores", 1e-4), ("expert_weights", 1e-4),
                      ("semantic_score", 1e-4), ("style_embedding", 1e-3),
                      ("prompt_embedding", 1e-3)):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), atol=atol,
                                   rtol=1e-3, err_msg=key)
    ref = teacher_state_dict_from_jax(pair["tp"], _numpy(new_stats),
                                      pair["tcfg"])
    for k, v in teacher.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=k)
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k


def test_teacher_train_mode_is_not_ported(pair):
    """Windowed attention in train mode, which was the part of train mode
    not ported: the teacher with attn_window 256 (4 windows at 32 px, 9 at
    48 px), dropout 0, against the JAX teacher at the bar of
    test_teacher_train_mode_matches, and its running statistics."""
    tcfg = dataclasses.replace(pair["tcfg"], attn_window=256)
    x = np.random.default_rng(16).uniform(
        -1, 1, (2, pair["size"], pair["size"], 3)).astype(np.float32)
    want, new_stats = jax.jit(lambda p, s, x: jteacher.apply(
        p, s, x, cfg=tcfg, train=True))(pair["tp"], pair["ts"], x)
    teacher = LunarMoETeacher(tcfg)
    teacher.load_state_dict(pair["teacher"].state_dict(), strict=True)
    got = tteacher.apply(teacher, torch.from_numpy(x), train=True)
    for key, atol in (("quality_scores", 1e-4), ("expert_weights", 1e-4),
                      ("semantic_score", 1e-4), ("style_embedding", 1e-3),
                      ("prompt_embedding", 1e-3)):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), atol=atol,
                                   rtol=1e-3, err_msg=key)
    ref = teacher_state_dict_from_jax(pair["tp"], _numpy(new_stats), tcfg)
    for k, v in teacher.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=k)


def test_seeded_init_is_reproducible_and_jax_shaped():
    """reset_parameters(generator) draws the JAX package's init
    distributions: same seed, same weights; torch defaults for the VAE,
    kaiming fan-out (zero bias) for the teacher."""
    vcfg, tcfg = _cfgs(32)
    a, b = LunarisCoreVAE(vcfg), LunarisCoreVAE(vcfg)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    bound = 1 / np.sqrt(3 * 9)
    w = a.encoder.down1[0].weight
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    t = LunarMoETeacher(tcfg)
    t.reset_parameters(torch.Generator().manual_seed(4))
    conv = t.experts[0][0].conv1[0]
    assert torch.count_nonzero(conv.bias) == 0
    std = np.sqrt(2 / (1 + 0.01 ** 2)) / np.sqrt(conv.weight.shape[0] * 9)
    assert abs(conv.weight.std().item() / std - 1) < 0.1
    assert torch.all(t.experts[1][1].layer_scale == tcfg.layer_scale_init)
