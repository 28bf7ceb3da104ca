"""The port's checkpoint conversion CLI (`lunaris_orion_tpu_torch.cli.
convert`, `lunaris-convert-torch`) on the CPU.

The input is a reference-layout .pt written by the JAX package's own
writer (`torch_compat.torch_checkpoint_from_state`): `to-port` then
`to-torch` gives it back tensor for tensor, bit for bit; config.json is
`utils.convert.train_config_from_reference_args` of its args, with the
dims overrides; the port's readers load the directory; and the JAX
package's `lunaris-convert to-jax` reads what `to-torch` wrote.
"""

import json

import jax
import numpy as np
import pytest
import torch

from lunaris_orion_tpu.config import TrainConfig
from lunaris_orion_tpu.train.state import create_state
from lunaris_orion_tpu.utils import torch_compat as tc
from lunaris_orion_tpu_torch.cli.convert import PORT_KEYS
from lunaris_orion_tpu_torch.cli.convert import main as convert
from lunaris_orion_tpu_torch.infer.generator import ImageGenerator
from lunaris_orion_tpu_torch.utils.convert import (
    train_config_from_reference_args)
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)

TINY = TrainConfig(latent_dim=16, embedding_dim=8, feature_dim=16,
                   num_experts=2, image_size=32)


@pytest.fixture(scope="module")
def ref_pt(tmp_path_factory):
    """A reference .pt at step 5 with both models, both AdamW states, the
    schedulers, best_loss and args."""
    state = create_state(jax.random.PRNGKey(0), TINY)
    ckpt = tc.torch_checkpoint_from_state(
        state.replace(step=np.int32(5), best_loss=np.float32(0.25)), TINY)
    path = tmp_path_factory.mktemp("ref") / "latest.pt"
    torch.save(ckpt, path)
    return path


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_same(a, b, where="ckpt"):
    """Equal structure; tensors equal in dtype, shape and every bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        bits = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
        assert torch.equal(bits(a), bits(b)), where
    elif isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_to_port_then_to_torch_is_bit_equal(ref_pt, tmp_path):
    d = tmp_path / "ckpts"
    assert convert(["to-port", "--checkpoint", str(ref_pt), "--out", str(d),
                    "--best"]) == 0
    assert (d / "steps" / "5.pt").is_file() and (d / "best.pt").is_file()
    ref = _load(ref_pt)
    for flags in ([], ["--best"], ["--step", "5"]):
        out = tmp_path / f"back{len(flags)}.pt"
        assert convert(["to-torch", "--checkpoint", str(d), "--out",
                        str(out)] + flags) == 0
        _assert_same(ref, _load(out))
    gen = ImageGenerator(str(d), device="cpu")
    assert gen.step == 5 and gen.cfg.latent_dim == TINY.latent_dim


def test_config_json_is_the_reference_args(ref_pt, tmp_path):
    d = tmp_path / "ckpts"
    assert convert(["to-port", "--checkpoint", str(ref_pt), "--out",
                    str(d)]) == 0
    want = train_config_from_reference_args(_load(ref_pt)["args"])
    got = json.loads((d / "config.json").read_text())
    assert got == json.loads(json.dumps(want.to_dict(), default=str))
    assert not (d / "best.pt").exists()


def test_dims_overrides(ref_pt, tmp_path):
    """An args snapshot that misdescribes the tensors fails the strict
    load; the overrides repair it, in config.json and in the file's
    args, and leave the tensors as they are."""
    ref = _load(ref_pt)
    ref["args"] = dict(ref["args"], latent_dim=32, feature_dim=64)
    bad = tmp_path / "bad.pt"
    torch.save(ref, bad)
    with pytest.raises(RuntimeError, match="size mismatch"):
        convert(["to-port", "--checkpoint", str(bad), "--out",
                 str(tmp_path / "x")])
    d = tmp_path / "fixed"
    assert convert(["to-port", "--checkpoint", str(bad), "--out", str(d),
                    "--latent_dim", "16", "--feature_dim", "16"]) == 0
    cfg = json.loads((d / "config.json").read_text())
    assert (cfg["latent_dim"], cfg["feature_dim"]) == (16, 16)
    written = _load(d / "steps" / "5.pt")
    assert (written["args"]["latent_dim"],
            written["args"]["feature_dim"]) == (16, 16)
    _assert_same(ref["vae_state_dict"], written["vae_state_dict"])
    _assert_same(ref["teacher_optimizer"], written["teacher_optimizer"])


def test_to_torch_drops_the_port_keys(tmp_path):
    """A directory of the port's trainer: the .pt keeps every reference
    key bit for bit and drops baseline, baseline_initialized and
    generator_state."""
    from lunaris_orion_tpu_torch import TrainConfig as PortConfig
    from lunaris_orion_tpu_torch.train.checkpoint import CheckpointService
    from lunaris_orion_tpu_torch.train.state import create_state as port_state
    cfg = PortConfig.from_dict(TINY.to_dict())
    svc = CheckpointService(str(tmp_path / "run"), keep_n=2)
    state = port_state(cfg, "cpu", 0)
    for step in (2, 4):
        state.step = step
        svc.save(step, state, config=cfg)
    svc.close()
    out = tmp_path / "out.pt"
    assert convert(["to-torch", "--checkpoint", str(tmp_path / "run"),
                    "--out", str(out)]) == 0
    src = _load(tmp_path / "run" / "steps" / "4.pt")
    assert set(PORT_KEYS) <= set(src)
    _assert_same({k: v for k, v in src.items() if k not in PORT_KEYS},
                 _load(out))
    with pytest.raises(FileNotFoundError, match="best.pt"):
        convert(["to-torch", "--checkpoint", str(tmp_path / "run"),
                 "--out", str(out), "--best"])


def test_jax_to_jax_reads_the_port_output(ref_pt, tmp_path):
    """The JAX package's `lunaris-convert to-jax` reads the port's
    `to-torch` output, and its own `to-torch` gives the same tensors
    back."""
    from lunaris_orion_tpu.cli.convert import main as jax_convert
    d = tmp_path / "ckpts"
    assert convert(["to-port", "--checkpoint", str(ref_pt), "--out",
                    str(d)]) == 0
    port_pt = tmp_path / "port.pt"
    assert convert(["to-torch", "--checkpoint", str(d), "--out",
                    str(port_pt)]) == 0
    orbax = tmp_path / "orbax"
    assert jax_convert(["to-jax", "--checkpoint", str(port_pt), "--out",
                        str(orbax)]) == 0
    back = tmp_path / "back.pt"
    assert jax_convert(["to-torch", "--checkpoint", str(orbax), "--out",
                        str(back)]) == 0
    got, want = _load(back), _load(port_pt)
    assert got["global_step"] == 5
    for key in ("vae_state_dict", "teacher_state_dict"):
        for k, v in want[key].items():
            np.testing.assert_array_equal(got[key][k].numpy(), v.numpy(),
                                          err_msg=k)
