"""The port's evaluator (lunaris_orion_tpu_torch/infer/evaluator.py,
cli/evaluate.py) against the JAX package's `QualityEvaluator` on one
reference-layout .pt that both packages read: per-image scores of a
directory of PNGs in two shapes and a sprite shard, with an attention
window that one shape cannot tile (the global fallback), and without one;
the CLI; and `generate` from a checkpoint trained with `attn_window`
against the JAX generator on one z. On the CPU at 32 px (N = 1024 tokens);
inputs are made with numpy; every tolerance is stated beside its
comparison."""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lunaris_orion_tpu.config import TrainConfig
from lunaris_orion_tpu.infer.evaluator import QualityEvaluator as JaxEvaluator
from lunaris_orion_tpu.infer.generator import ImageGenerator as JaxGenerator
from lunaris_orion_tpu_torch.cli import evaluate as cli
from lunaris_orion_tpu_torch.infer.evaluator import QualityEvaluator
from lunaris_orion_tpu_torch.infer.generator import ImageGenerator
from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)

# teacher_config() keeps extractor 128 and 8 heads: feature_dim 64 -> head
# size 8 (a K2 head size), 32 px -> N = 1024 tokens (4 windows of 256).
TINY = TrainConfig(latent_dim=16, embedding_dim=8, feature_dim=64,
                   num_experts=2, image_size=32)


def _save(cfg, path, seed):
    g = torch.Generator().manual_seed(seed)
    vae = LunarisCoreVAE(cfg.vae_config())
    vae.reset_parameters(g)
    teacher = LunarMoETeacher(cfg.teacher_config())
    teacher.reset_parameters(g)
    torch.save({"vae_state_dict": vae.state_dict(),
                "teacher_state_dict": teacher.state_dict(),
                "args": cfg.to_dict(), "global_step": 3}, path)
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _save(TINY, tmp_path_factory.mktemp("ckpt") / "tiny.pt", 0)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Five 32 px PNGs, two 24 px ones (576 tokens: window 256 cannot tile
    them) and a shard of three 32 px sprites."""
    d = tmp_path_factory.mktemp("images")
    r = np.random.default_rng(1)
    for i in range(5):
        Image.fromarray(r.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
            d / f"a{i}.png")
    for i in range(2):
        Image.fromarray(r.integers(0, 256, (24, 24, 3), dtype=np.uint8)).save(
            d / f"odd{i}.png")
    np.save(d / "sprites_0.npy", r.integers(0, 256, (3, 32, 32, 3),
                                            dtype=np.uint8))
    return d


def _assert_same_scores(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert set(g) == set(w), key
        assert g.get("attn_mode") == w.get("attn_mode"), key
        # f32 scoring on both sides: quality, semantic and gate at 1e-4
        # (tests/test_teacher_interop.py's bar).
        for name in ("edge_quality", "color_consistency", "detail",
                     "overall", "mean_quality", "semantic_score"):
            np.testing.assert_allclose(g[name], w[name], atol=1e-4, rtol=0,
                                       err_msg=f"{key}.{name}")
        np.testing.assert_allclose(g["expert_weights"], w["expert_weights"],
                                   atol=1e-4, rtol=0, err_msg=key)


@pytest.mark.parametrize("window", [None, 256])
def test_score_directory_matches_jax(ckpt, images, window):
    """Batches of 4: the 32 px group in two batches, the 24 px group (with
    window 256: global attention, marked, with a warning), the shard."""
    want = JaxEvaluator(str(ckpt), attn_window=window).score_directory(
        str(images), batch_size=4)
    ev = QualityEvaluator(str(ckpt), attn_window=window, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = ev.score_directory(str(images), batch_size=4)
    assert len(got) == 10
    fallback = sorted(k for k, v in got.items() if "attn_mode" in v)
    assert fallback == (["odd0.png", "odd1.png"] if window else [])
    assert len([w for w in caught if "global-fallback" in str(w.message)]) \
        == (1 if window else 0)
    _assert_same_scores(got, want)


def test_windowed_scores_differ_from_global(ckpt):
    """The override reaches the attention: window 256 and the global
    fallback of one evaluator differ on a 32 px batch, and the fallback
    equals a window-free evaluator's scores."""
    x = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3),
                                          dtype=np.uint8)
    ev = QualityEvaluator(str(ckpt), attn_window=256, device="cpu")
    win = ev.score_batch(x)
    glob = ev.score_batch(x, global_attn=True)
    plain = QualityEvaluator(str(ckpt), device="cpu").score_batch(x)
    assert max(abs(a["semantic_score"] - b["semantic_score"]) + abs(
        a["mean_quality"] - b["mean_quality"]) for a, b in zip(win, glob)) > 0
    assert glob == plain


def test_cli_matches_the_evaluator(ckpt, images, tmp_path, capsys):
    out = tmp_path / "scores.json"
    rc = cli.main(["--checkpoint", str(ckpt), "--input", str(images),
                   "--output", str(out), "--batch_size", "4", "--device",
                   "cpu", "--attn_window", "256"])
    assert rc == 0 and "Scored 10 images" in capsys.readouterr().out
    want = QualityEvaluator(str(ckpt), attn_window=256,
                            device="cpu").score_directory(str(images),
                                                          batch_size=4)
    assert json.loads(out.read_text()) == want
    args = cli.build_parser().parse_args(["--checkpoint", "c", "--input", "i"])
    assert args.device == "cuda" and args.attn_window is None
    assert not args.bf16 and args.batch_size == 64


def test_bf16_tracks_f32(ckpt):
    x = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3),
                                          dtype=np.uint8)
    a = QualityEvaluator(str(ckpt), attn_window=256, device="cpu")
    b = QualityEvaluator(str(ckpt), attn_window=256, bf16=True, device="cpu")
    # bf16 keeps ~3 significant digits through ~20 layers: a loose bar.
    for s, t in zip(a.score_batch(x), b.score_batch(x)):
        assert abs(s["mean_quality"] - t["mean_quality"]) < 0.02


def test_evaluator_sources(ckpt, tmp_path):
    """A port checkpoint directory (its latest step, or best) reads; an
    Orbax directory raises naming the converter; no card raises."""
    with pytest.raises(ValueError, match="lunaris-convert to-torch"):
        QualityEvaluator(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="single checkpoint"):
        QualityEvaluator(str(ckpt), best=True, device="cpu")
    (tmp_path / "steps").mkdir()
    (tmp_path / "steps" / "4.pt").write_bytes(ckpt.read_bytes())
    ev = QualityEvaluator(str(tmp_path), device="cpu")
    assert ev.tcfg.feature_dim == 64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            QualityEvaluator(str(ckpt))


def test_generate_on_a_windowed_checkpoint_matches_jax(tmp_path):
    """A checkpoint whose config has attn_window 256 decodes and scores in
    both packages from one z: images within 1/255, quality and semantic
    at 1e-4; the port's generate runs on it."""
    cfg = TINY.replace(attn_window=256)
    path = _save(cfg, tmp_path / "windowed.pt", 1)
    z = np.random.default_rng(4).standard_normal((2, 16)).astype(np.float32)
    jg = JaxGenerator(str(path))
    assert jg.tcfg.attn_window == 256
    want = [np.asarray(t) for t in jg._decode_and_score(
        jg.vae_params, jg.teacher_params, jg.teacher_stats, jnp.asarray(z))]
    gen = ImageGenerator(str(path), device="cpu")
    assert gen.tcfg.attn_window == 256
    got = [t.numpy() for t in gen.decode_and_score(torch.from_numpy(z))]
    np.testing.assert_allclose(got[0], want[0], atol=1 / 255, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    imgs, meta = gen.generate(2, max_attempts=1, seed=0)
    assert imgs.shape == (2, 32, 32, 3) and len(meta) == 2
