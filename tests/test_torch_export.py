"""The port's serving export (`lunaris_orion_tpu_torch.infer.exporter`,
`cli.export`) and its torch.library operators (`ops/library.py`) on the
CPU, against the port's eager path and the JAX package's exporter.

  * both operators pass `torch.library.opcheck` (schema, fake tensors,
    autograd registration, AOT dispatch), f32 and bf16;
  * a "plain" bundle at 32 px: its manifest, weights stored once, the
    `generate` program equal to eager `decode_and_score` (uint8 exact,
    scores atol 1e-5), the `score` program within 1e-4 of the JAX
    exporter's `attn="xla"` score program on the same .pt;
  * the "cuda" form's graph traced on the CPU holds one
    `lunaris_orion::gn_mish` a decoder K1 site and one
    `lunaris_orion::flash_attention_fwd` an expert block, global at 64 px
    (N = 4096) and windowed at 32 px, and gives the plain form's outputs
    (on the CPU the operators run the same plain twins);
  * a bundle loads in a fresh interpreter with torch alone, and through
    `ServingBundle` without importing the port's model code;
  * unknown batch sizes and bad arguments raise; the CLI round trip.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lunaris_orion_tpu.config import TrainConfig
from lunaris_orion_tpu_torch.infer import exporter as E
from lunaris_orion_tpu_torch.infer.generator import ImageGenerator
from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
from lunaris_orion_tpu_torch.ops import library
from lunaris_orion_tpu_torch.utils.image import to_uint8
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
# 32 px: N = 1024 tokens, the `auto` rule's full attention; 64 px: N =
# 4096, K2. feature_dim 16 at 8 heads: head dim 2 (the plain twins take
# any head size).
TINY = TrainConfig(latent_dim=16, embedding_dim=8, feature_dim=16,
                   num_experts=2, image_size=32)


def _save(path: Path, cfg: TrainConfig, seed: int) -> Path:
    g = torch.Generator().manual_seed(seed)
    vae = LunarisCoreVAE(cfg.vae_config())
    vae.reset_parameters(g)
    teacher = LunarMoETeacher(cfg.teacher_config())
    teacher.reset_parameters(g)
    torch.save({"vae_state_dict": vae.state_dict(),
                "teacher_state_dict": teacher.state_dict(),
                "args": cfg.to_dict(), "global_step": 7}, path)
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _save(tmp_path_factory.mktemp("ckpt") / "tiny.pt", TINY, 0)


@pytest.fixture(scope="module")
def bundle_dir(ckpt, tmp_path_factory):
    d = tmp_path_factory.mktemp("bundle")
    manifest = E.export_serving_bundle(
        str(ckpt), str(d), batch_sizes=(2, 3), attn="plain", device="cpu")
    assert len(manifest["functions"]) == 4
    return d


@pytest.fixture(scope="module")
def z():
    return np.random.default_rng(7).standard_normal(
        (2, TINY.latent_dim)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["gn_mish", "flash_attention_fwd"])
def test_opcheck(op, dtype):
    g = torch.Generator().manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g)
    if op == "gn_mish":
        args = (rand(2, 4, 4, 16).to(dtype), rand(16), rand(16), 8, 1e-5)
    else:
        args = (rand(2, 2, 64, 16).to(dtype), rand(2, 2, 48, 16).to(dtype),
                rand(2, 2, 48, 16).to(dtype), rand(2, 48), 0, 0)
    result = torch.library.opcheck(getattr(library, op), args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_manifest_contents(bundle_dir):
    m = json.loads((bundle_dir / "manifest.json").read_text())
    assert m["format"] == E.FORMAT
    assert m["attn"] == "plain" and m["bf16"] is False
    assert m["requires"] == []
    assert m["torch_version"] == torch.__version__
    assert m["latent_dim"] == TINY.latent_dim
    assert m["image_size"] == TINY.image_size
    assert m["checkpoint_step"] == 7
    assert m["config"]["num_experts"] == TINY.num_experts
    assert sorted(m["functions"]) == ["generate_b2_cpu", "generate_b3_cpu",
                                      "score_b2_cpu", "score_b3_cpu"]
    for e in m["functions"].values():
        assert (bundle_dir / e["file"]).exists()
        assert e["platforms"] == ["cpu"]
    assert m["functions"]["generate_b2_cpu"]["in_avals"] == ["float32[2, 16]"]
    assert m["functions"]["score_b3_cpu"]["in_avals"] == [
        "uint8[3, 32, 32, 3]"]


def test_weights_stored_once_not_baked(ckpt, bundle_dir):
    """weights.bin holds the decoder and the teacher once, bit for bit;
    each program stays under a tenth of it."""
    m = json.loads((bundle_dir / "manifest.json").read_text())
    wsize = (bundle_dir / m["weights_file"]).stat().st_size
    assert wsize == sum(e["nbytes"] for e in m["weights"])
    gen = ImageGenerator(str(ckpt), device="cpu")
    want = E.bundle_weights(gen.vae, gen.teacher)
    assert [e["name"] for e in m["weights"]] == list(want)
    got = E.read_weights(bundle_dir / m["weights_file"], m["weights"], "cpu")
    for (name, ref), t in zip(want.items(), got):
        assert t.dtype == ref.dtype and torch.equal(t, ref), name
    for e in m["functions"].values():
        psize = (bundle_dir / e["file"]).stat().st_size
        assert psize < 0.1 * wsize, (
            f"{e['file']} is {psize} B against {wsize} B of weights")


def test_generate_matches_eager(ckpt, bundle_dir, z):
    imgs, q, s = E.ServingBundle(str(bundle_dir), device="cpu").generate(z)
    assert imgs.shape == (2, 32, 32, 3) and imgs.dtype == np.uint8
    assert q.shape == (2,) and s.shape == (2,)
    gen = ImageGenerator(str(ckpt), device="cpu")
    d_imgs, d_q, d_s = gen.decode_and_score(torch.from_numpy(z))
    np.testing.assert_array_equal(imgs, to_uint8(d_imgs.numpy()))
    np.testing.assert_allclose(q, d_q.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(s, d_s.numpy(), rtol=0, atol=1e-5)


def test_score_matches_jax_bundle(ckpt, bundle_dir, tmp_path):
    """The port's plain score program against the JAX exporter's portable
    (`attn="xla"`) score program, exported from the same .pt."""
    from lunaris_orion_tpu.infer.exporter import ServingBundle as JaxBundle
    from lunaris_orion_tpu.infer.exporter import export_serving_bundle
    imgs = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                             dtype=np.uint8)
    export_serving_bundle(str(ckpt), str(tmp_path / "jax"), batch_sizes=(3,),
                          functions=("score",), attn="xla")
    ref = JaxBundle(str(tmp_path / "jax")).score(imgs)
    got = E.ServingBundle(str(bundle_dir), device="cpu").score(imgs)
    assert [g.shape for g in got] == [(3, 4), (3, TINY.num_experts), (3,),
                                      (3, TINY.embedding_dim)]
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-4)


def _ops(ep) -> dict:
    counts = {"gn_mish": 0, "flash_attention_fwd": 0}
    for node in ep.graph.nodes:
        name = str(node.target)
        if name.startswith(f"{library.NAMESPACE}."):
            counts[name.split(".")[1]] += 1
    return counts


@pytest.mark.parametrize("image_size, window", [(64, 0), (32, 256)])
def test_cuda_form_graph_holds_the_operators(tmp_path, image_size, window):
    """The "cuda" form traced on the CPU: one K1 operator a decoder site,
    one K2 operator an expert block (global at N = 4096; windowed at
    N = 1024 over 4 windows folded into the heads), none in the plain
    form; both forms give the same outputs."""
    cfg = TINY.replace(image_size=image_size, attn_window=window)
    gen = ImageGenerator(str(_save(tmp_path / "c.pt", cfg, 1)), device="cpu")
    weights = list(E.bundle_weights(gen.vae, gen.teacher).values())
    blocks = cfg.num_experts * gen.tcfg.expert_layers
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, cfg.latent_dim)).astype(np.float32))
    imgs = None
    for function, want in (("generate", {"gn_mish": gen.vcfg.num_down,
                                         "flash_attention_fwd": blocks}),
                           ("score", {"gn_mish": 0,
                                      "flash_attention_fwd": blocks})):
        x = z if function == "generate" else imgs
        cuda_ep = E.export_program(gen.vae, gen.teacher, function, 1,
                                   attn="cuda")
        plain_ep = E.export_program(gen.vae, gen.teacher, function, 1,
                                    attn="plain")
        assert _ops(cuda_ep) == want
        assert _ops(plain_ep) == {"gn_mish": 0, "flash_attention_fwd": 0}
        got = cuda_ep.module()(weights, x)
        ref = plain_ep.module()(weights, x)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        if function == "generate":
            imgs = got[0]


def test_bf16_cuda_form_matches_eager(ckpt, z):
    """bf16: the "cuda" form's program equal to eager bf16
    decode_and_score (uint8 exact, scores atol 1e-5)."""
    gen = ImageGenerator(str(ckpt), device="cpu", bf16=True)
    ep = E.export_program(gen.vae, gen.teacher, "generate", 2, bf16=True)
    weights = list(E.bundle_weights(gen.vae, gen.teacher).values())
    imgs, q, s = ep.module()(weights, torch.from_numpy(z))
    d_imgs, d_q, d_s = gen.decode_and_score(torch.from_numpy(z))
    np.testing.assert_array_equal(imgs.numpy(), to_uint8(d_imgs.numpy()))
    np.testing.assert_allclose(q.numpy(), d_q.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), d_s.numpy(), rtol=0, atol=1e-5)


def test_fresh_interpreter_loads_without_model_code(bundle_dir, z):
    """A plain bundle runs in a fresh interpreter with torch alone (no
    module of the port imported), and through ServingBundle without the
    port's model modules or jax."""
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "d = sys.argv[1]\n"
        "m = json.load(open(d + '/manifest.json'))\n"
        "blob = bytearray(open(d + '/weights.bin', 'rb').read())\n"
        "w = [torch.frombuffer(blob, dtype=getattr(torch, e['dtype']),\n"
        "      count=int(np.prod(e['shape'], dtype=np.int64)),\n"
        "      offset=e['offset']).reshape(e['shape']) for e in m['weights']]\n"
        "z = torch.from_numpy(np.load(sys.argv[2]))\n"
        "prog = torch.export.load(d + '/' + m['functions']\n"
        "                         ['generate_b2_cpu']['file']).module()\n"
        "bare = [o.numpy() for o in prog(w, z)]\n"
        "assert not [k for k in sys.modules if k.startswith('lunaris')]\n"
        "from lunaris_orion_tpu_torch.infer.exporter import ServingBundle\n"
        "out = ServingBundle(d, device='cpu').generate(z.numpy())\n"
        "assert all(np.array_equal(a, b) for a, b in zip(bare, out))\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib',\n"
        "       'lunaris_orion_tpu') or k.startswith(\n"
        "       'lunaris_orion_tpu_torch.models')]\n"
        "assert not bad, bad\n"
        "print(json.dumps([o.tolist() for o in out[1:]]))\n")
    np.save(bundle_dir / "z.npy", z)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(bundle_dir),
         str(bundle_dir / "z.npy")], cwd=bundle_dir, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    q, s = json.loads(proc.stdout.strip().splitlines()[-1])
    _, q_ref, s_ref = E.ServingBundle(str(bundle_dir), device="cpu").generate(z)
    np.testing.assert_array_equal(np.float32(q), q_ref)
    np.testing.assert_array_equal(np.float32(s), s_ref)


def test_unknown_batch_size_raises(bundle_dir):
    bundle = E.ServingBundle(str(bundle_dir), device="cpu")
    with pytest.raises(ValueError, match="batch 5.*\\[2, 3\\]"):
        bundle.generate(np.zeros((5, TINY.latent_dim), np.float32))


def test_bad_args_raise(ckpt, tmp_path):
    out = str(tmp_path / "x")
    with pytest.raises(ValueError, match="platforms must be \\['cuda'\\]"):
        E.export_serving_bundle(str(ckpt), out, attn="cuda",
                                platforms=["cuda", "cpu"])
    with pytest.raises(ValueError, match="platforms must be \\['cuda'\\]"):
        E.export_serving_bundle(str(ckpt), out, attn="cuda", device="cpu")
    with pytest.raises(ValueError, match="attn must be one of"):
        E.export_serving_bundle(str(ckpt), out, attn="xla", device="cpu")
    with pytest.raises(ValueError, match="platforms must be among"):
        E.export_serving_bundle(str(ckpt), out, attn="plain",
                                platforms=["tpu"])
    with pytest.raises(ValueError, match="unknown functions"):
        E.export_serving_bundle(str(ckpt), out, attn="plain", device="cpu",
                                functions=("generate", "nope"))
    with pytest.raises(ValueError, match="not a serving bundle"):
        (tmp_path / "m").mkdir()
        (tmp_path / "m" / "manifest.json").write_text('{"format": "x"}')
        E.ServingBundle(str(tmp_path / "m"), device="cpu")


def test_cli_roundtrip(ckpt, tmp_path):
    from lunaris_orion_tpu_torch.cli.export import main as export_main
    out = tmp_path / "cli_bundle"
    rc = export_main(["--checkpoint", str(ckpt), "--out", str(out),
                      "--batch", "2", "--functions", "score", "--attn",
                      "plain", "--device", "cpu"])
    assert rc == 0
    bundle = E.ServingBundle(str(out), device="cpu")
    assert bundle.batch_sizes("score") == [2]
    assert bundle.batch_sizes("generate") == []
    q, w, _, _ = bundle.score(np.zeros((2, 32, 32, 3), np.uint8))
    assert np.isfinite(q).all() and np.allclose(w.sum(-1), 1.0, atol=1e-5)


def test_weights_blob_roundtrip_bf16(tmp_path):
    """_write_weights / read_weights keep every type bit for bit: bf16, an
    int64 scalar, f32."""
    weights = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
               "b": torch.linspace(-2, 2, 8).to(torch.bfloat16),
               "c": torch.tensor(3, dtype=torch.int64)}
    index = E._write_weights(tmp_path, weights)
    back = E.read_weights(tmp_path / "weights.bin", index, "cpu")
    for (name, ref), t in zip(weights.items(), back):
        assert t.dtype == ref.dtype and t.shape == ref.shape, name
        assert torch.equal(t, ref), name
