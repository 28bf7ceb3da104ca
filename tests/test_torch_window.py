"""Windowed attention in the PyTorch port (lunaris_orion_tpu_torch/ops/
attention.py `local_window_attention`, K2 over the windows folded into the
head axis) against the JAX package's `local_window_attention`: outputs and
gradients at dropout 0, the global path and the two errors, batch chunks
under a lowered row cap, the hash mask and its keep rate; then the teacher
with `attn_window` in eval and train mode, and two whole train steps with
`attn_window` against the JAX step. Inputs are made with numpy; every
tolerance is stated beside its comparison."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lunaris_orion_tpu.models import teacher as jteacher
from lunaris_orion_tpu.ops import attention as jattn
from lunaris_orion_tpu_torch.models import teacher as tteacher
from lunaris_orion_tpu_torch.ops.attention import (WindowTilingError,
                                                   local_window_attention)
from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
from lunaris_orion_tpu_torch.utils.convert import teacher_state_dict_from_jax
from test_torch_attention import _module_pair, _qkvb, _t
from test_torch_models import _cfgs, _numpy, _randomize_stats
from test_torch_train import two_steps_match


def _jax_window(q, k, v, bias, window):
    return np.asarray(jattn.local_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), window=window))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("window", [64, 128, 256])
def test_local_window_matches_jax(window, with_bias):
    q, k, v, bias = _qkvb(2, 2, 1024, 1024, 8, seed=window)
    want = _jax_window(q, k, v, bias if with_bias else None, window)
    got = local_window_attention(
        *_t(q, k, v), torch.from_numpy(bias if with_bias
                                       else np.zeros_like(bias)),
        window=window)
    assert got.shape == q.shape
    # f32; K2's plain version against dense softmax windows: atol 1e-5.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("window", [256, 512])
def test_window_of_n_or_more_is_global(window):
    q, k, v, bias = _qkvb(1, 2, 256, 256, 16, seed=3)
    want = np.asarray(jattn.full_attention(*map(jnp.asarray, (q, k, v, bias))))
    got = local_window_attention(*_t(q, k, v, bias), window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_window_errors():
    tq = _t(*_qkvb(1, 2, 256, 256, 8, seed=4))
    for window in (0, -64):
        with pytest.raises(ValueError, match="positive") as e:
            local_window_attention(*tq, window=window)
        assert not isinstance(e.value, WindowTilingError)
    with pytest.raises(WindowTilingError, match="divide"):
        local_window_attention(*tq, window=100)


@pytest.mark.parametrize("d,window", [(8, 64), (16, 128)])
def test_window_grads_match_jax(d, window):
    """dq, dk, dv and dbias against jax.grad of the JAX windowed path, at
    the bar of tests/test_torch_attention_bwd.py."""
    q, k, v, bias = _qkvb(2, 2, 512, 512, d, seed=d)
    do = np.random.default_rng(d + 1).standard_normal(q.shape).astype(
        np.float32)

    def loss(q, k, v, bias):
        o = jattn.local_window_attention(q, k, v, bias, window=window)
        return jnp.sum(o * jnp.asarray(do))
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, bias)))
    ts = [t.requires_grad_() for t in _t(q, k, v, bias)]
    local_window_attention(*ts, window=window).backward(torch.from_numpy(do))
    # f32 throughout; blockings and summation orders differ: atol 1e-5.
    for name, t, w in zip(("dq", "dk", "dv", "dbias"), ts, want):
        assert t.grad.shape == w.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_batch_chunks_equal_one_call(monkeypatch):
    """With K2's row cap lowered to 2 images' folded rows, a batch of 5
    runs in 3 chunks numbered as rows of one call: the output (dropout mask
    included) is the one call's bit for bit; the gradients too, but for
    dbias, which sums the chunks in another order (atol 1e-6)."""
    q, k, v, bias = _qkvb(5, 2, 256, 256, 8, seed=5)
    do = torch.from_numpy(np.random.default_rng(6).standard_normal(
        q.shape).astype(np.float32))
    kw = dict(window=64, dropout_rate=0.1, seed=-77)
    runs = []
    for cap in (k2.MAX_ROWS, 2 * 2 * 4):
        monkeypatch.setattr(k2, "MAX_ROWS", cap)
        calls = []
        orig = k2.flash_attention
        monkeypatch.setattr(k2, "flash_attention",
                            lambda *a, **kw2: calls.append(kw2) or orig(*a, **kw2))
        ts = [t.requires_grad_() for t in _t(q, k, v, bias)]
        o = local_window_attention(*ts, **kw)
        o.backward(do)
        monkeypatch.setattr(k2, "flash_attention", orig)
        runs.append((o.detach(), [t.grad for t in ts], calls))
    (o1, g1, c1), (o3, g3, c3) = runs
    assert [c["row_offset"] for c in c1] == [0]
    assert [c["row_offset"] for c in c3] == [0, 16, 32]
    assert torch.equal(o1, o3)
    for a, b in zip(g1[:3], g3[:3]):
        assert torch.equal(a, b)
    torch.testing.assert_close(g1[3], g3[3], atol=1e-6, rtol=0)
    monkeypatch.setattr(k2, "MAX_ROWS", 2)
    with pytest.raises(ValueError, match="rows"):
        local_window_attention(*_t(q, k, v, bias), window=64)


def test_window_dropout_is_the_hash_on_folded_rows():
    """At rate 0.1 the output is dense windowed attention with K2's hash
    mask over (seed, folded row b * H * nW + h * nW + w, position in the
    window), which keeps 0.9 of the probabilities (within 0.005 over
    2 x 2 x 4 windows of 64 x 64)."""
    b, h, n, d, w, rate, seed = 2, 2, 256, 8, 64, 0.1, 12345
    q, k, v, bias = _t(*_qkvb(b, h, n, n, d, seed=7))
    got = local_window_attention(q, k, v, bias, window=w, dropout_rate=rate,
                                 seed=seed)
    nw = n // w
    fold = lambda t: t.reshape(b, h * nw, w, d)
    s = (fold(q) * d ** -0.5) @ fold(k).transpose(-1, -2) \
        + bias.reshape(h * nw, 1, w)
    p = torch.softmax(s, dim=-1)
    rs = k2.row_seeds(seed, b * h * nw).reshape(b, h * nw, 1, 1)
    pos = torch.arange(w, dtype=torch.int64)
    keep = k2.keep_mask(rs, pos[None, :], pos[:, None],
                        k2.dropout_threshold(1 - rate))
    assert abs(keep.float().mean().item() - 0.9) < 0.005
    want = torch.where(keep, p / (1 - rate), torch.zeros_like(p)) @ fold(v)
    # f32; two-pass plain version against one dense softmax: atol 1e-5.
    torch.testing.assert_close(got, want.reshape(b, h, n, d), atol=1e-5,
                               rtol=0)


def test_spatial_attention_window_matches_reference():
    """SpatialAttention with a window below N (32 x 32 tokens, window 256)
    against spatial_attention_reference with the same window."""
    jp, m = _module_pair(16, 2, key=11)
    x = np.random.default_rng(8).standard_normal((2, 32, 32, 16)).astype(
        np.float32)
    want = np.asarray(jattn.spatial_attention_reference(
        jp, jnp.asarray(x), num_heads=2, window=256))
    with torch.no_grad():
        got = m(torch.from_numpy(x), window=256)
    # f32; conv, softmax and blocking orders differ: atol 1e-5, rtol 1e-4.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="cannot combine"):
        m(torch.from_numpy(x), window=256, impl="ring")


# --- the teacher --------------------------------------------------------------

@pytest.fixture(scope="module")
def windowed():
    """The 48 px teacher of tests/test_torch_models.py (N = 2304) with
    attn_window 256 (9 windows), in both packages."""
    _, tcfg = _cfgs(48)
    tcfg = dataclasses.replace(tcfg, attn_window=256)
    tp, ts = jteacher.init(jax.random.PRNGKey(21), tcfg)
    tp, ts = _numpy(tp), _randomize_stats(_numpy(ts), 21)
    teacher = tteacher.LunarMoETeacher(tcfg).eval()
    teacher.load_state_dict(teacher_state_dict_from_jax(tp, ts, tcfg),
                            strict=True)
    return dict(tcfg=tcfg, tp=tp, ts=ts, teacher=teacher)


def test_windowed_teacher_eval_matches_jax(windowed):
    """Eval mode, and `global_attn` (the evaluator's fallback) against the
    JAX teacher without the window: quality, gate and semantic score at
    1e-4 (tests/test_teacher_interop.py's bar), embeddings at 1e-3."""
    x = np.random.default_rng(9).uniform(-1, 1, (2, 48, 48, 3)).astype(
        np.float32)
    tcfg = windowed["tcfg"]
    for global_attn, cfg in ((False, tcfg),
                             (True, dataclasses.replace(tcfg,
                                                        attn_window=None))):
        want, _ = jteacher.apply(windowed["tp"], windowed["ts"],
                                 jnp.asarray(x), cfg=cfg, train=False)
        with torch.no_grad():
            got = windowed["teacher"](torch.from_numpy(x),
                                      global_attn=global_attn)
        for key, atol in (("quality_scores", 1e-4), ("expert_weights", 1e-4),
                          ("semantic_score", 1e-4), ("style_embedding", 1e-3),
                          ("prompt_embedding", 1e-3)):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=atol, rtol=1e-3,
                                       err_msg=f"{key} global={global_attn}")


@pytest.mark.parametrize("remat", [True, False])
def test_windowed_teacher_train_matches_jax(windowed, remat):
    """Train mode at dropout 0 with remat on and off, with gradients: the
    outputs at 1e-4; the gradients of sum(quality) to every attention
    parameter (the windowed K2 backward's dq, dk, dv and dbias reach them
    first) at 3e-3 of each tensor's largest. The global teacher on the same
    input reads up to 1.0e-3 there (its qkv biases): train-mode BatchNorm
    and LeakyReLU after the attention pass rounding differences on; a
    misplaced window moves them by O(1)."""
    tcfg = windowed["tcfg"]
    x = np.random.default_rng(10).uniform(-1, 1, (2, 48, 48, 3)).astype(
        np.float32)

    def jloss(p):
        out, _ = jteacher.apply(p, windowed["ts"], jnp.asarray(x), cfg=tcfg,
                                train=True, remat=remat)
        return jnp.sum(out["quality_scores"]), out
    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, windowed["tp"]))
    teacher = copy.deepcopy(windowed["teacher"])
    got = tteacher.apply(teacher, torch.from_numpy(x), train=True,
                         remat=remat)
    got["quality_scores"].sum().backward()
    for key in ("quality_scores", "expert_weights", "semantic_score"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), atol=1e-4,
                                   rtol=1e-3, err_msg=key)
    want_g = teacher_state_dict_from_jax(_numpy(jgrad), windowed["ts"], tcfg)
    got_g = dict(teacher.named_parameters())
    names = [k for k in got_g if ".attention." in k]
    assert len(names) == 6 * tcfg.num_experts * tcfg.expert_layers
    for k in names:
        w = want_g[k].numpy()
        np.testing.assert_allclose(got_g[k].grad.numpy(), w, rtol=0,
                                   atol=3e-3 * np.abs(w).max(), err_msg=k)


# --- the train step -----------------------------------------------------------

def test_train_step_with_window_matches_jax(monkeypatch):
    """Two optimizer steps with attn_window 256 at 48 px (9 windows of the
    2304 tokens), at the bars of tests/test_torch_train.py's whole-step
    test: metrics, parameters, BatchNorm statistics and AdamW's moments
    against the JAX step's."""
    two_steps_match(monkeypatch, 48, attn_window=256)
