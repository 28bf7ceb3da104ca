"""The port's long parity runs (lunaris_orion_tpu_torch/tools/parity_*.py,
window_dynamics.py) against the JAX package.

The JAX reference curves and the init they start from are committed under
lunaris_orion_tpu_torch/tools/parity_ref/, because the port never imports
JAX and one 200-step JAX hybrid run takes 45 to 64 minutes of CPU. This
module makes them:

    JAX_PLATFORMS=cpu python tests/test_torch_parity_curves.py --write \
        [--runs vae.deterministic,...] [--steps N]

(one process a run; the runs are independent and can go in parallel), and
its tests hold the committed files to the JAX package's sources and the
port on the CPU to the curves.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO / "tools"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lunaris_orion_tpu_torch.tools import _parity as P  # noqa: E402


def jax_source_hash() -> str:
    """sha256 over lunaris_orion_tpu/**/*.py: each file's path relative to
    the repo, then its bytes, in sorted order."""
    h = hashlib.sha256()
    for p in sorted((REPO / "lunaris_orion_tpu").rglob("*.py")):
        h.update(p.relative_to(REPO).as_posix().encode() + b"\0")
        h.update(p.read_bytes() + b"\0")
    return h.hexdigest()


def _commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def _jax_cfgs(preset, window=0):
    """The JAX package's configs with the preset's fields."""
    from lunaris_orion_tpu import config as jc
    vcfg = jc.VAEConfig(**dataclasses.asdict(preset.vae))
    if preset.teacher is None:
        return None, vcfg, None
    tcfg = jc.TeacherConfig(**dataclasses.asdict(
        P.teacher_config(preset, window)))
    cfg = jc.TrainConfig(**{f.name: getattr(preset.train, f.name)
                            for f in dataclasses.fields(jc.TrainConfig)})
    return cfg, vcfg, tcfg


def mirror_init():
    """torch.manual_seed(7), then the reference VAE and the hybrid_d16
    teacher drawn by the test mirrors, as the JAX tools draw their init
    (parity_hybrid.py:74-76; parity_curves.py draws the VAE alone first,
    which is the same VAE). Returns (vae_sd, teacher_sd)."""
    from test_teacher_interop import MirrorTeacher
    from test_torch_parity import TorchMirrorVAE
    from lunaris_orion_tpu import config as jc
    preset = P.PRESETS["hybrid_d16"]
    torch.manual_seed(P.INIT_SEED)
    vae = TorchMirrorVAE(jc.VAEConfig(**dataclasses.asdict(preset.vae)))
    teacher = MirrorTeacher(jc.TeacherConfig(**dataclasses.asdict(
        preset.teacher)))
    return ({k: v.detach().clone() for k, v in vae.state_dict().items()},
            {k: v.detach().clone() for k, v in teacher.state_dict().items()})


def reference_layout(tsd):
    """The mirror teacher's state dict with the reference's
    `attention.last_spatial_shapes` buffers, which the mirror lacks."""
    out = dict(tsd)
    for k in tsd:
        if k.endswith("attention.qkv.weight"):
            out[k.replace("qkv.weight", "last_spatial_shapes")] = \
                torch.zeros(2)
    return out


def write_init(stamp):
    vsd, tsd = mirror_init()
    P.REF_DIR.mkdir(parents=True, exist_ok=True)
    torch.save({"vae_state_dict": vsd,
                "teacher_state_dict": reference_layout(tsd),
                "global_step": 0, **stamp}, P.INIT)


def write_bands(stamp):
    out = {"bands": {}, "source": {}, **stamp}
    for name, doc, keys in (("vae", "docs/parity_curves.json", P.VAE_METRICS),
                            ("hybrid", "docs/parity_hybrid.json", P.METRICS)):
        d = json.loads((REPO / doc).read_text())
        out["bands"][name] = {
            mode: {k: d[mode]["max_rel_divergence"][k] for k in keys}
            for mode in ("deterministic", "sampled")}
        out["source"][name] = (f"{doc}: max_rel_divergence of each mode, "
                               "the JAX package against an independent "
                               "PyTorch loop from one init")
    P.write_json(P.BANDS, out)


def jax_curves(run, steps):
    """The JAX package's own step over `steps` steps of `run`, from the
    committed init: jvae.apply + recon_kl + the optax chain (the JAX
    tool's `run_jax`) for `vae`, make_train_step(..., remat=False,
    attn_impl='full') for the hybrid."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    name, sampled, window = P.RUNS[run]
    preset = P.PRESETS[name]
    ckpt = torch.load(P.INIT, map_location="cpu", weights_only=True)
    sd0 = {"vae": {k: v.numpy() for k, v in ckpt["vae_state_dict"].items()},
           "teacher": {k: v.numpy()
                       for k, v in ckpt["teacher_state_dict"].items()
                       if not k.endswith("last_spatial_shapes")}}
    data = P.make_data(steps, preset.batch, preset.vae.image_size)
    cfg, vcfg, tcfg = _jax_cfgs(preset, window)
    if tcfg is None:
        import parity_curves
        return parity_curves.run_jax(data, vcfg, sd0["vae"], sampled,
                                     seed=P.INIT_SEED)
    import parity_hybrid
    return parity_hybrid.run_jax(data, cfg, vcfg, tcfg, sd0, sampled,
                                 seed=P.INIT_SEED)


def write_reference(run, steps, stamp):
    curves = jax_curves(run, steps)
    name, sampled, window = P.RUNS[run]
    P.write_json(P.REF_DIR / f"{run}.json", {
        "run": run, "preset": name, "sampled": sampled, "window": window,
        "steps": steps, "batch": P.PRESETS[name].batch,
        "curves": curves, **stamp})


def write_port_cpu(stamp):
    """The port's tools on the CPU at full length against every committed
    reference: parity_ref/port_cpu.json, the divergences and ms a step."""
    from lunaris_orion_tpu_torch.tools import parity_curves, parity_hybrid
    out = {"device": "cpu", "runs": {}, **stamp}
    for run, (preset, sampled, window) in P.RUNS.items():
        steps = P.PRESETS[preset].steps
        if preset == "vae":
            r = parity_curves.run_mode("cpu", steps, sampled)
        else:
            r = parity_hybrid.run_mode("cpu", steps, sampled, window)
        out["runs"][run] = {"steps": steps,
                            "max_rel_divergence": r["max_rel_divergence"],
                            "ms_per_step": r["ms_per_step"]}
        print(P.summary_line(run, r["max_rel_divergence"], P.bands(preset),
                             sampled), flush=True)
    P.write_json(P.REF_DIR / "port_cpu.json", out)


def _stamp():
    return {"jax_source_sha256": jax_source_hash(), "commit": _commit()}


# --- the tests ---------------------------------------------------------------

REF_FILES = sorted(P.REF_DIR.glob("*.json"))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the runs here are many small steps, which
    torch's default of one thread a core slows several times over on a
    host whose cores other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_committed_init_is_the_seed7_mirrors_and_the_port_loads_it():
    ckpt = torch.load(P.INIT, map_location="cpu", weights_only=True)
    vsd, tsd = mirror_init()
    assert set(ckpt["vae_state_dict"]) == set(vsd)
    for k, v in vsd.items():
        assert torch.equal(ckpt["vae_state_dict"][k], v), k
    extra = set(ckpt["teacher_state_dict"]) - set(tsd)
    assert extra and all(k.endswith("last_spatial_shapes") for k in extra)
    for k, v in tsd.items():
        assert torch.equal(ckpt["teacher_state_dict"][k], v), k
    vae, teacher = P.load_init(P.PRESETS["hybrid_d16"])
    for k, v in vae.state_dict().items():
        assert torch.equal(v, vsd[k]), k
    for k, v in teacher.state_dict().items():
        if k in tsd:
            assert torch.equal(v, tsd[k]), k
    assert P.load_init(P.PRESETS["vae"])[1] is None


def test_every_reference_file_carries_the_jax_source_hash():
    """The cheap guard against stale references: every committed file was
    made from the JAX package's sources as they stand."""
    want = jax_source_hash()
    names = {p.stem for p in REF_FILES}
    assert set(P.RUNS) | {"bands"} <= names
    for path in REF_FILES:
        assert P.load_json(path)["jax_source_sha256"] == want, path.name
    ckpt = torch.load(P.INIT, map_location="cpu", weights_only=True)
    assert ckpt["jax_source_sha256"] == want
    for run, (preset, _, _) in P.RUNS.items():
        ref = P.reference(run)
        assert ref["steps"] == P.PRESETS[preset].steps, run
        assert all(len(v) == ref["steps"] for v in ref["curves"].values())


def test_recorded_cpu_runs_meet_the_deterministic_bands():
    """parity_ref/port_cpu.json, the port's full-length runs on the CPU
    (`--write --runs port_cpu`): every run of RUNS at its preset's length,
    each deterministic divergence within its deterministic band."""
    rec = P.load_json(P.REF_DIR / "port_cpu.json")["runs"]
    assert set(rec) == set(P.RUNS)
    for run, (preset, sampled, _) in P.RUNS.items():
        assert rec[run]["steps"] == P.PRESETS[preset].steps
        if not sampled:
            band = P.bands(preset)["deterministic"]
            for k, v in rec[run]["max_rel_divergence"].items():
                assert v <= band[k], (run, k, v, band[k])


def test_bands_are_the_docs_measurements():
    for name, doc in (("vae", "parity_curves"), ("hybrid", "parity_hybrid")):
        d = json.loads((REPO / "docs" / f"{doc}.json").read_text())
        for mode, band in P.bands("hybrid_d16" if name == "hybrid" else
                                  "vae").items():
            assert band == {k: d[mode]["max_rel_divergence"][k]
                            for k in band}, (name, mode)


def test_vae_reference_is_the_docs_torch_curve():
    """The committed deterministic JAX curve (the JAX package on the CPU)
    against docs/parity_curves.json, made from the same init, data and
    step: it overlays the docs' independent PyTorch loop (1.2e-5 at most,
    measured), while the docs' JAX curve sits 6.8e-4 (recon) and 1.1e-2
    (KL) away, the deterministic bands themselves. That JAX run took its
    f32 convolutions and products at the TPU's default precision, so the
    deterministic bands are a TPU run's distance from an f32 one."""
    docs = json.loads((REPO / "docs/parity_curves.json").read_text())
    ref = P.reference("vae.deterministic")["curves"]
    band = P.bands("vae")["deterministic"]
    for k in P.VAE_METRICS:
        torch_curve = docs["deterministic"]["torch"][k]
        gap = np.abs(np.subtract(ref[k], torch_curve)) / np.maximum(
            np.abs(torch_curve), 1e-3)
        assert gap.max() < 5e-5, (k, gap.max())
        jax_tpu = P.back_half_divergence(ref[k], docs["deterministic"]["jax"][k],
                                         P.floor_for(k))
        assert 0.5 * band[k] < jax_tpu < 2 * band[k], (k, jax_tpu, band[k])


@pytest.mark.parametrize("run,steps", [
    ("vae.deterministic", 30),
    ("hybrid_d16.deterministic", 5),
    ("hybrid_d16.deterministic_w256", 5),
])
def test_port_on_the_cpu_tracks_the_jax_curves(run, steps):
    """The port's step with its plain twins against the committed JAX
    curves, every step run within the deterministic band (the full
    lengths: `test_recorded_cpu_runs_meet_the_deterministic_bands`)."""
    from lunaris_orion_tpu_torch.tools import parity_curves, parity_hybrid
    preset, sampled, window = P.RUNS[run]
    if preset == "vae":
        r = parity_curves.VAERun("cpu", steps, sampled)
    else:
        r = parity_hybrid.HybridRun("cpu", steps, sampled, window)
    for i in range(steps):
        r.step(i)
    port = r.curves()
    band = P.bands(preset)["deterministic"]
    for k, ref in P.reference(run)["curves"].items():
        gap = np.abs(np.subtract(port[k], ref[:steps])) / np.maximum(
            np.abs(ref[:steps]), P.floor_for(k))
        assert gap.max() <= band[k], (k, gap.max(), band[k])


def test_back_half_divergence_is_the_jax_tools_formula():
    """The JAX tools' formula (parity_curves.py:206-210,
    parity_hybrid.py:283-288) with the reference as the denominator."""
    rng = np.random.default_rng(3)
    ref = rng.normal(size=40)
    ref[25] = 1e-5                       # below the floor
    port = ref + rng.normal(scale=1e-3, size=40)
    h = 20
    want = np.max(np.abs(ref[h:] - port[h:])
                  / np.maximum(np.abs(ref[h:]), 1e-3))
    assert P.back_half_divergence(port, ref, 1e-3) == pytest.approx(
        want, rel=1e-12)
    bare = np.max(np.abs(ref[h:] - port[h:]) / np.abs(ref[h:]))
    assert P.back_half_divergence(port, ref, 0.0) == pytest.approx(
        bare, rel=1e-12)
    assert P.floor_for("recon") == 0.0 and P.floor_for("kl") == 1e-3
    assert P.floor_for("recon_loss") == 1e-3
    with pytest.raises(ValueError):
        P.back_half_divergence(port[:10], ref, 1e-3)


def test_make_data_is_byte_equal_to_the_jax_tools():
    import parity_curves
    import parity_hybrid
    for steps, batch, size in ((3, 16, 32), (2, 8, 32), (1, 4, 16)):
        got = P.make_data(steps, batch, size)
        assert got.dtype == np.uint8
        assert got.tobytes() == parity_curves.make_data(
            steps, batch, size).tobytes()
        assert got.tobytes() == parity_hybrid.make_data(
            steps, batch, size).tobytes()


def test_deterministic_z_restores_reparameterize():
    from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
    before = LunarisCoreVAE.__dict__["reparameterize"]
    mu, logvar = torch.randn(4, 6), torch.zeros(4, 6)
    with P.deterministic_z():
        gen = torch.Generator().manual_seed(0)
        assert torch.equal(LunarisCoreVAE.reparameterize(mu, logvar, gen), mu)
    assert LunarisCoreVAE.__dict__["reparameterize"] is before
    gen = torch.Generator().manual_seed(0)
    assert not torch.equal(LunarisCoreVAE.reparameterize(mu, logvar, gen), mu)
    with pytest.raises(KeyError), P.deterministic_z():
        raise KeyError
    assert LunarisCoreVAE.__dict__["reparameterize"] is before


@pytest.mark.parametrize("tool,args,modes,keys", [
    ("parity_curves", [], ("deterministic", "sampled"), P.VAE_METRICS),
    ("parity_hybrid", ["--attn_window", "256", "--modes", "deterministic"],
     ("deterministic_w256",), P.METRICS),
    ("window_dynamics", ["--image_size", "16", "--batch", "2"],
     ("global", "256"), None),
])
def test_tools_main_writes_the_expected_keys(tool, args, modes, keys,
                                             tmp_path):
    import importlib
    mod = importlib.import_module(f"lunaris_orion_tpu_torch.tools.{tool}")
    out = tmp_path / "out.json"
    steps = 3 if tool == "parity_curves" else 2
    assert mod.main(["--device", "cpu", "--steps", str(steps),
                     "--out", str(out)] + args) == 0
    got = json.loads(out.read_text())
    assert got["device"] == "cpu"
    for mode in modes:
        r = got[mode]
        if keys is None:
            assert set(r["trajectories"]) == set(mod.KEYS)
            assert r["steps"] == steps and r["ms_per_step"] > 0
            continue
        assert set(r["port"]) == set(keys)
        assert set(r["max_rel_divergence"]) == set(keys)
        assert all(len(v) == steps for v in r["port"].values())
        assert all(np.isfinite(v) for v in r["max_rel_divergence"].values())


@pytest.mark.parametrize("tool", ["parity_curves", "parity_hybrid",
                                  "window_dynamics"])
def test_tools_ask_for_a_card_by_default(tool):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    import importlib
    mod = importlib.import_module(f"lunaris_orion_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(["--steps", "1"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", required=True)
    ap.add_argument("--runs", default="init,bands," + ",".join(P.RUNS),
                    help="comma list of init, bands, run names and "
                         "port_cpu (the port on the CPU against them all)")
    ap.add_argument("--steps", type=int, default=0,
                    help="steps of each run (default: the preset's)")
    args = ap.parse_args(argv)
    stamp = _stamp()
    for run in [r for r in args.runs.split(",") if r]:
        if run == "init":
            write_init(stamp)
        elif run == "bands":
            write_bands(stamp)
        elif run == "port_cpu":
            write_port_cpu(stamp)
        else:
            steps = args.steps or P.PRESETS[P.RUNS[run][0]].steps
            write_reference(run, steps, stamp)
        print(f"wrote {run}", flush=True)


if __name__ == "__main__":
    main()
