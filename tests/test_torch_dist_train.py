"""The port's train step and Trainer across 2 and 4 ranks, on the CPU,
against the JAX package's step on a mesh of as many devices (its state
placed by `state_shardings`: tensor and expert parallelism where the mesh
has a model axis) and against the port's own single-process step.

The JAX side runs in this process on the forced host devices of
tests/conftest.py, with tests/test_sharding.py's set-up at 16 px (one
expert block, 4 heads, teacher dropout 0: JAX draws its dropout masks from
jax.random, the port from torch generators) and one fixed eps in both
packages. The port's side runs in gloo ranks started with
`torch.multiprocessing` spawn, which import torch only (this module
imports JAX inside its tests); one spawn of 2 ranks runs every check of
the (data, model) meshes (2, 1) and (1, 2), one of 4 ranks the (2, 2)
step, and each rank writes its results to a file; the comparisons run
here. A rank under tensor / expert parallelism records its own part of
the gradients (compared with the same part of the reference,
`_part`) and the gathered whole parameters (`gather_state`). Every
tolerance is stated beside its comparison."""

import dataclasses
import sys

import numpy as np
import pytest
import torch
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)

A, BG, SIZE, LATENT = 2, 4, 16, 16
# (tag, mesh shape, attention impl). (1, 2) without ring / allgather is
# tensor and expert parallelism; ring and allgather split the FC pair too.
STEP_CASES = (("dp", (2, 1), "auto"), ("allgather", (1, 2), "allgather"),
              ("ring", (1, 2), "ring"), ("tp_ep", (1, 2), "auto"))
FOUR_RANK_CASE = ("dp_tp_ep", (2, 2), "auto")
# (tag, mesh shape, attention window): dropout 0.1 against the port's own
# single-process step.
DROPOUT_CASES = (("dp_dropout", (2, 1), None),
                 ("dp_dropout_window", (2, 1), 64),
                 ("tp_ep_dropout", (1, 2), None))


def _configs(dropout_rate=0.0, window=None):
    """The port's configs (the JAX package's have the same fields)."""
    from lunaris_orion_tpu_torch.config import (TeacherConfig, TrainConfig,
                                                VAEConfig)
    vcfg = VAEConfig(latent_dim=LATENT, image_size=SIZE, base_channels=16)
    tcfg = TeacherConfig(
        num_experts=2, feature_dim=16, extractor_dim=16, extractor_stem=8,
        branch_dim=8, expert_layers=1, intermediate_dim=16, embedding_dim=8,
        num_heads=4, rel_pos_size=4, image_size=SIZE,
        dropout_rate=dropout_rate, attn_window=window)
    cfg = TrainConfig(batch_size=BG, gradient_accumulation_steps=A,
                      latent_dim=LATENT, feature_dim=16, num_experts=2,
                      embedding_dim=8, image_size=SIZE)
    return cfg, vcfg, tcfg


def _eps():
    return np.random.default_rng(6).standard_normal((BG, LATENT)).astype(
        np.float32)


def _images():
    return np.random.default_rng(2).integers(
        0, 256, (A, BG, SIZE, SIZE, 3), dtype=np.uint8)


def _fix_eps(eps):
    """The VAE's posterior draw replaced by one eps [BG, L] for every
    micro-step; a data rank takes its rows of it, a model rank under
    tensor parallelism its latent columns."""
    from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE

    def rep(mu, logvar, generator=None, rows=None, cols=None):
        e = torch.from_numpy(eps)
        if rows is not None:
            b = mu.shape[0]
            e = e[rows.index * b:(rows.index + 1) * b]
        if cols is not None:
            c = mu.shape[1]
            e = e[:, cols.index * c:(cols.index + 1) * c]
        std = torch.exp(0.5 * logvar.float())
        return (mu.float() + e * std).to(mu.dtype)
    LunarisCoreVAE.reparameterize = staticmethod(rep)


def _state(weights, dropout_rate=0.0, window=None):
    from lunaris_orion_tpu_torch.train.state import create_state
    cfg, vcfg, tcfg = _configs(dropout_rate, window)
    st = create_state(cfg, "cpu", 0, vcfg, tcfg)
    if weights is not None:
        st.vae.load_state_dict(weights["vae"])
        st.teacher.load_state_dict(weights["teacher"])
    return st


def _record(out, tag, st, metrics, mesh=None):
    """The metrics, this rank's gradients (its part under tensor / expert
    parallelism), and the whole parameters and BatchNorm statistics
    (gathered over the model axis)."""
    from lunaris_orion_tpu_torch.parallel.sharding import gather_state
    for k, v in metrics.items():
        out[f"{tag}/metric/{k}"] = np.float32(v)
    out[f"{tag}/model_index"] = np.int64(0 if mesh is None
                                         else mesh.model.index)
    for prefix, model in (("vae.", st.vae), ("teacher.", st.teacher)):
        for k, p in model.named_parameters():
            out[f"{tag}/grad/{prefix}{k}"] = p.grad.numpy().copy()
    whole = gather_state(st, mesh)
    for prefix, model in (("vae.", whole.vae), ("teacher.", whole.teacher)):
        for k, p in model.named_parameters():
            out[f"{tag}/param/{prefix}{k}"] = p.detach().numpy().copy()
        for k, b in model.named_buffers():
            if "running" in k:
                out[f"{tag}/buf/{prefix}{k}"] = b.numpy().copy()


def _holdings(out, tag, st):
    """What a rank holds under tensor / expert parallelism: its experts
    and quality heads, and the shapes of its parameters and moments."""
    out[f"{tag}/experts"] = np.asarray(
        [e for e, ex in enumerate(st.teacher.experts) if ex is not None])
    out[f"{tag}/heads"] = np.asarray(
        [e for e, h in enumerate(st.teacher.quality_heads) if h is not None])
    for prefix, model, opt in (("vae.", st.vae, st.vae_opt),
                               ("teacher.", st.teacher, st.teacher_opt)):
        for (k, p), part in zip(model.named_parameters(), opt.split):
            moments = opt.opt.state[p]
            out[f"{tag}/shape/{prefix}{k}"] = np.asarray(
                [p.shape, moments["exp_avg"].shape,
                 moments["exp_avg_sq"].shape])
            out[f"{tag}/split/{prefix}{k}"] = np.bool_(part)


def _local(images, mesh):
    """This rank's data-axis share of the global batch [A, BG, ...]."""
    b = BG // mesh.data.size
    return images[:, mesh.data.index * b:(mesh.data.index + 1) * b]


def _step_case(out, case, weights, images):
    """One step case of STEP_CASES on this rank: the state cut to the
    rank's part (`shard_state`; experts stay whole under ring /
    allgather), one step, the record."""
    from lunaris_orion_tpu_torch.parallel.mesh import make_mesh
    from lunaris_orion_tpu_torch.parallel.sharding import shard_state
    from lunaris_orion_tpu_torch.train import step as pstep
    tag, shape, impl = case
    mesh = make_mesh(shape, device="cpu")
    cp = ({} if impl == "auto" else
          dict(cp_mesh=mesh, cp_axis="model", cp_batch_axis="data"))
    st = shard_state(_state(weights), mesh, shard_experts=impl == "auto")
    st, m = pstep.make_train_step(_configs()[0], attn_impl=impl, mesh=mesh,
                                  **cp)(st, _local(images, mesh))
    _record(out, tag, st, m, mesh)
    return st


def _ranks(rank, path):
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None   # no TensorFlow import
    from lunaris_orion_tpu_torch.parallel import close_mesh, init_mesh
    from lunaris_orion_tpu_torch.parallel.mesh import make_mesh
    from lunaris_orion_tpu_torch.parallel.sharding import shard_state
    from lunaris_orion_tpu_torch.train import step as pstep
    weights = torch.load(path / "weights.pt")
    images = torch.from_numpy(_images())
    out = {}
    init_mesh((2, 1), device="cpu")
    try:
        from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
        original = LunarisCoreVAE.__dict__["reparameterize"]
        _fix_eps(_eps())
        cfg = _configs()[0]
        # The replicated gradients a rank of a model row holds before the
        # step takes the model axis's first rank's (`broadcast_`): whole
        # on their own.
        broadcast, held = pstep.broadcast_, []

        def recording(tensors, axis):
            if not held:
                held.append(torch.cat([t.reshape(-1) for t in tensors]))
            broadcast(tensors, axis)
        pstep.broadcast_ = recording
        for case in STEP_CASES:
            held.clear()
            st = _step_case(out, case, weights, images)
            if held:
                out[f"{case[0]}/held"] = held[0].numpy()
            if case[0] == "tp_ep":
                _holdings(out, "tp_ep", st)
        pstep.broadcast_ = broadcast
        LunarisCoreVAE.reparameterize = original
        # Dropout on (0.1 everywhere, K2's hash in the attention, global
        # or over windows of 64 tokens): the draws are the global batch's,
        # so the DP step is the single-process step; under tensor / expert
        # parallelism a rank draws the seeds and masks of the experts it
        # skips too.
        for tag, shape, window in DROPOUT_CASES:
            mesh = make_mesh(shape, device="cpu")
            st = shard_state(_state(weights, 0.1, window), mesh)
            st, m = pstep.make_train_step(cfg, attn_impl="flash", mesh=mesh)(
                st, _local(images, mesh))
            _record(out, tag, st, m, mesh)
        _trainer(out, path, make_mesh((2, 1), device="cpu"))
        _tp_ep_trainer(out, path)
        np.savez(path / f"rank{rank}.npz", **out)
    finally:
        close_mesh()


def _four_ranks(rank, path):
    """The (2, 2) step: data and model axes both above 1."""
    torch.set_num_threads(1)
    from lunaris_orion_tpu_torch.parallel import close_mesh, init_mesh
    weights = torch.load(path / "weights.pt")
    out = {}
    init_mesh(FOUR_RANK_CASE[1], device="cpu")
    try:
        _fix_eps(_eps())
        _step_case(out, FOUR_RANK_CASE, weights, torch.from_numpy(_images()))
        np.savez(path / f"four{rank}.npz", **out)
    finally:
        close_mesh()


def _trainer(out, path, mesh):
    """A 2-rank Trainer (--mesh_shape 2 1, cached prompt embeddings, AdamW's
    first moments in bf16): the
    loader's staged indices of epoch 0, the metrics of each step, the
    embedding table; then a resume from its checkpoint directory and one
    more epoch."""
    from lunaris_orion_tpu_torch.config import TrainConfig
    from lunaris_orion_tpu_torch.train import loop
    from lunaris_orion_tpu_torch.train.step import make_embed_step
    cfg = TrainConfig(
        data_dir=str(path / "sprites"), output_dir=str(path / "run"),
        force_cpu=True, batch_size=4, gradient_accumulation_steps=2,
        num_epochs=1, latent_dim=16, feature_dim=16, num_experts=2,
        embedding_dim=8, image_size=SIZE, val_fraction=0.2,
        mesh_shape=(2, 1), cached_prompt_embeddings=True,
        bf16_momentum=True, log_every=1,
        save_every=0, eval_save_freq=0, sample_every=0)
    t = loop.Trainer(cfg)
    out["trainer/train_indices"] = t.tr_idx
    t.train_loader.set_epoch(0)
    out["trainer/indices"] = np.stack([idx for _, idx in t.train_loader])
    out["trainer/own_table"] = loop.compute_embed_table(
        make_embed_step(t.cfg), t.state, t.dataset, batch_size=4,
        embedding_dim=8, device=t.device).numpy()
    step, seen = t.train_step, []

    def recorded(*a):
        state, m = step(*a)
        seen.append([float(m[k]) for k in sorted(m)])
        return state, m
    t.train_step = recorded
    t.train()
    out["trainer/metrics"] = np.asarray(seen)
    out["trainer/table"] = t._embed_table.numpy()
    trained = {k: v.clone() for k, v in t.state.teacher.state_dict().items()}
    r = loop.Trainer(dataclasses.replace(
        cfg, resume_from=str(path / "run" / "checkpoints")))
    out["trainer/resumed_step"] = np.int64(r.state.step)
    out["trainer/resumed_equal"] = np.bool_(all(
        torch.equal(v, trained[k])
        for k, v in r.state.teacher.state_dict().items()))
    r.train()
    out["trainer/final"] = torch.cat([p.detach().reshape(-1) for p in
                                      r.state.vae.parameters()]).numpy()
    out["trainer/final_step"] = np.int64(r.state.step)


def _tp_ep_trainer_config(path, run, **kw):
    from lunaris_orion_tpu_torch.config import TrainConfig
    return TrainConfig(
        data_dir=str(path / "sprites"), output_dir=str(path / run),
        force_cpu=True, batch_size=4, gradient_accumulation_steps=2,
        num_epochs=1, latent_dim=16, feature_dim=16, num_experts=2,
        embedding_dim=8, image_size=SIZE, val_fraction=0.2, log_every=1,
        save_every=0, eval_save_freq=0, sample_every=0, **kw)


def _tp_ep_trainer(out, path):
    """A 2-rank Trainer at --mesh_shape 1 2 (tensor and expert
    parallelism): one epoch, its checkpoint (rank 0 writes the gathered
    state), what each rank holds, and its memory plan's probe micro-step
    on the split models (the plan probes only where the device has a
    memory figure, so it is called here by hand)."""
    from lunaris_orion_tpu_torch.train import loop
    t = loop.Trainer(_tp_ep_trainer_config(path, "tp_ep_run",
                                           mesh_shape=(1, 2)))
    t.train()
    before = [v.clone() for m in (t.state.vae, t.state.teacher)
              for v in m.state_dict().values()]
    t._probe(t.cfg, t.remat)
    out["tp_ep_trainer/probe_kept_state"] = np.bool_(all(
        torch.equal(a, b) for a, b in zip(before, (
            v for m in (t.state.vae, t.state.teacher)
            for v in m.state_dict().values()))))
    out["tp_ep_trainer/step"] = np.int64(t.state.step)
    out["tp_ep_trainer/experts"] = np.asarray(
        [e for e, ex in enumerate(t.state.teacher.experts) if ex is not None])
    out["tp_ep_trainer/fc_mu_rows"] = np.int64(
        t.state.vae.encoder.fc_mu.weight.shape[0])


def _jax_state(path):
    """The JAX package's initial state and configs, and its weights in the
    port's layout, saved for the ranks."""
    import jax
    from lunaris_orion_tpu import config as jconfig
    from lunaris_orion_tpu.train import state as jstate
    from lunaris_orion_tpu_torch.utils.convert import (
        teacher_state_dict_from_jax, vae_state_dict_from_jax)
    pcfg, pvcfg, ptcfg = _configs()
    jcfgs = (jconfig.TrainConfig(**dataclasses.asdict(pcfg)),
             jconfig.VAEConfig(**dataclasses.asdict(pvcfg)),
             jconfig.TeacherConfig(**dataclasses.asdict(ptcfg)))
    js = jstate.create_state(jax.random.PRNGKey(0), *jcfgs)
    host = jax.tree_util.tree_map(np.asarray, js)
    weights = {"vae": vae_state_dict_from_jax(host.vae_params, pvcfg),
               "teacher": teacher_state_dict_from_jax(
                   host.teacher_params, host.teacher_stats, ptcfg)}
    torch.save(weights, path / "weights.pt")
    return js, jcfgs, weights


def _jax_steps(js, jcfgs, cases):
    """The JAX step of each case on a mesh of as many host devices, one
    fixed eps, the state placed by `state_shardings` with the bottleneck
    FC pair split over the model axis (tensor parallelism) and the
    experts whole. Not with the experts split too, as the JAX Trainer
    places them without ring / allgather: on the host platform of these
    tests (jax 0.9.0, XLA's CPU partitioner) that placement changes the
    JAX teacher's outputs, eval mode included (a (1, 2) mesh: the prompt
    embedding by up to 0.45 and the quality scores by up to 0.058 against
    the same call unsharded; a step's semantic_reward 0.0489 against
    0.0985), while every piece of the expert path tried alone (a vmapped
    conv, matmul, the expert einsums, expert 0's pooling) partitions
    exactly. So the JAX step with the experts whole is the JAX package's
    step, and the port's expert parallelism is held to it and to the
    port's own single-process step."""
    import jax
    import jax.numpy as jnp
    from lunaris_orion_tpu.models import vae as jvae
    from lunaris_orion_tpu.parallel import (batch_sharding, make_mesh,
                                            state_shardings)
    from lunaris_orion_tpu.train import step as jstep
    jcfg, jvcfg, jtcfg = jcfgs
    images, eps = _images(), _eps()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        def rep(rng, mu, logvar):
            std = jnp.exp(0.5 * logvar.astype(jnp.float32))
            return (mu.astype(jnp.float32) + jnp.asarray(eps) * std).astype(
                mu.dtype)
        mp.setattr(jvae, "reparameterize", rep)
        for tag, shape, impl in cases:
            mesh = make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
            shards = state_shardings(
                jax.eval_shape(lambda: js), mesh,
                num_experts=jtcfg.num_experts, latent_dim=jvcfg.latent_dim,
                shard_experts=False)
            cp = ({} if impl == "auto" else dict(
                cp_mesh=mesh, cp_axis="model", cp_batch_axis="data"))
            fn = jax.jit(jstep.make_train_step(jcfg, jvcfg, jtcfg,
                                               attn_impl=impl, **cp),
                         in_shardings=(shards, batch_sharding(mesh)),
                         out_shardings=(shards, None))
            s2, m = fn(jax.device_put(js, shards),
                       jax.device_put(images, batch_sharding(mesh)))
            out[tag] = (jax.tree_util.tree_map(np.asarray, s2),
                        {k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX step on the meshes of STEP_CASES, the port's single-process
    steps and Trainer, and the port's 2-rank results."""
    from lunaris_orion_tpu_torch.data.synthetic import write_synthetic_dataset
    from lunaris_orion_tpu_torch.parallel.launch import spawn
    from lunaris_orion_tpu_torch.train import step as pstep

    path = tmp_path_factory.mktemp("dist")
    pcfg, pvcfg, ptcfg = _configs()
    js, jcfgs, weights = _jax_state(path)
    write_synthetic_dataset(path / "sprites", 20, image_size=SIZE)
    jax_out = _jax_steps(js, jcfgs, STEP_CASES)

    images, eps = _images(), _eps()
    single = {}
    from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
    with pytest.MonkeyPatch.context() as pmp:
        pmp.setattr(LunarisCoreVAE, "reparameterize",
                    LunarisCoreVAE.__dict__["reparameterize"])
        _fix_eps(eps)
        st = _state(weights)
        st, m = pstep.make_train_step(pcfg)(st, torch.from_numpy(images))
        _record(single, "single", st, m)
    for tag, _, window in DROPOUT_CASES:
        st = _state(weights, 0.1, window)
        st, m = pstep.make_train_step(pcfg, attn_impl="flash")(
            st, torch.from_numpy(images))
        _record(single, f"single_{tag}", st, m)

    spawn(_ranks, 2, (path,))
    ranks = [dict(np.load(path / f"rank{r}.npz")) for r in range(2)]
    return dict(jax=jax_out, single=single, ranks=ranks, pvcfg=pvcfg,
                ptcfg=ptcfg, path=path)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The JAX step on one device and the port's 4 ranks at (2, 2)."""
    from lunaris_orion_tpu_torch.parallel.launch import spawn
    path = tmp_path_factory.mktemp("dist4")
    js, jcfgs, _ = _jax_state(path)
    # The JAX step on one device: on a (2, 2) mesh of the host platform
    # (jax 0.9.0) the JAX step, its state replicated or placed by
    # `state_shardings`, returns the feature extractor's gradients doubled
    # (its AdamW first moment 2x the one-device, (2, 1), (1, 2) and (4, 1)
    # steps'), with the same metrics.
    jax_out = _jax_steps(js, jcfgs, ((FOUR_RANK_CASE[0], (1, 1), "auto"),))
    spawn(_four_ranks, 4, (path,))
    ranks = [dict(np.load(path / f"four{r}.npz")) for r in range(4)]
    pcfg, pvcfg, ptcfg = _configs()
    return dict(jax=jax_out, ranks=ranks, pvcfg=pvcfg, ptcfg=ptcfg)


def _named(res, tag, kind):
    pre = f"{tag}/{kind}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _part(res, tag, shape, impl="auto"):
    """name, whole array -> the part of it the rank of `res` holds in case
    `tag` (its latent slice of the FC pair, its experts' tensors whole;
    `parallel.sharding.Layout.part`), None for another rank's expert's."""
    from lunaris_orion_tpu_torch.parallel.mesh import AxisGroup
    from lunaris_orion_tpu_torch.parallel.sharding import Layout
    if shape[1] == 1:
        return lambda name, a: a
    cfg, vcfg, tcfg = _configs()
    layout = Layout(AxisGroup(None, int(res[f"{tag}/model_index"]), shape[1],
                              ()), tcfg.num_experts, vcfg.latent_dim,
                    impl == "auto")
    def part(name, a):
        t = layout.part(name.split(".", 1)[1], torch.from_numpy(a))
        return None if t is None else t.numpy()
    return part


def _step_matches_jax(js, jm, ranks, case, vcfg, tcfg):
    """One rank set's step against the JAX step (the bars of
    `test_two_rank_step_matches_jax`)."""
    from lunaris_orion_tpu_torch.train.state import ClippedAdamW
    from lunaris_orion_tpu_torch.utils.convert import (
        teacher_state_dict_from_jax, vae_state_dict_from_jax)
    tag, shape, impl = case

    def flat(vae_tree, teacher_tree):
        out = {f"vae.{k}": v.numpy() for k, v in vae_state_dict_from_jax(
            vae_tree, vcfg).items()}
        out.update({f"teacher.{k}": v.numpy() for k, v in
                    teacher_state_dict_from_jax(teacher_tree,
                                                js.teacher_stats,
                                                tcfg).items()})
        return out
    want = flat(js.vae_params, js.teacher_params)
    grad = {k: v / np.float32(1 - ClippedAdamW.B1) for k, v in flat(
        js.vae_opt[1][0].mu, js.teacher_opt[1][0].mu).items()}
    grad = {k: grad[k] for k in _named(ranks[0], tag, "param")}
    bars = _grad_bars(grad, _before_bn())
    for r, res in enumerate(ranks):
        metrics = _named(res, tag, "metric")
        assert set(metrics) == set(jm)
        for k, v in jm.items():
            np.testing.assert_allclose(metrics[k], v, rtol=2e-4, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
        _grads_match(_named(res, tag, "grad"), grad, f"rank {r}",
                     _before_bn(), part=_part(res, tag, shape, impl))
        got = {**_named(res, tag, "param"), **_named(res, tag, "buf")}
        assert set(got) <= set(want)
        for k, a in got.items():
            b = want[k]
            noise = np.zeros(b.shape, bool)
            if k in grad:
                noise = ((np.abs(grad[k]) < bars[k])
                         | _zero_in_exact_arithmetic(k, b.shape))
            np.testing.assert_allclose(a[~noise], b[~noise], atol=1e-5,
                                       rtol=1e-4, err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(a[noise], b[noise], atol=2e-4, rtol=0,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("tag", [c[0] for c in STEP_CASES])
def test_two_rank_step_matches_jax(runs, tag):
    """One step (2 micro-batches of a global 4 at 16 px) of the port's 2
    ranks against the JAX package's step on the same mesh with the FC
    pair split (`_jax_steps`): DP (2, 1); CP (1, 2) with allgather and
    with ring, the FC pair split over the model axis as the JAX Trainer
    splits it; TP/EP (1, 2), the port's FC pair and experts split. Metrics at rtol 2e-4 / atol 1e-6
    (tests/test_sharding.py's bar). Each rank's averaged, clipped
    gradients (its own part of the split ones) against the same part of
    optax's first moment over (1 - b1), at `_grad_bars`' bar against the
    JAX step, the bar taken on the whole tensor. The whole (gathered)
    parameters and BatchNorm statistics at test_train_step_matches_jax's
    bar, atol 1e-5 / rtol 1e-4; a first Adam step moves an entry by lr
    times the sign of its gradient, so an entry whose gradient is under
    its bar is held within 2 lr."""
    case = next(c for c in STEP_CASES if c[0] == tag)
    js, jm = runs["jax"][tag]
    _step_matches_jax(js, jm, runs["ranks"], case, runs["pvcfg"],
                      runs["ptcfg"])


def test_four_rank_step_matches_jax(four_ranks):
    """The (2, 2) step (data parallelism over 2 data rows, tensor and
    expert parallelism over 2 model ranks each) against the JAX step on
    one device (`four_ranks`: the JAX step on a (2, 2) mesh of the host
    platform is not that step), at `test_two_rank_step_matches_jax`'s bars; the two data
    rows' ranks of one model index hold the same gradients, bit for bit."""
    js, jm = four_ranks["jax"][FOUR_RANK_CASE[0]]
    ranks = four_ranks["ranks"]
    _step_matches_jax(js, jm, ranks, FOUR_RANK_CASE, four_ranks["pvcfg"],
                      four_ranks["ptcfg"])
    tag = FOUR_RANK_CASE[0]
    for a, b in ((ranks[0], ranks[2]), (ranks[1], ranks[3])):
        ga, gb = _named(a, tag, "grad"), _named(b, tag, "grad")
        assert set(ga) == set(gb)
        for k in ga:
            np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)


def _grad_bars(want, before_bn=None):
    """Each gradient's absolute bar (with rtol 1e-3). Within the port: the
    moments' bar of tests/test_torch_train.py, 1e-5 of the model's largest
    gradient. Against the JAX package's step (`before_bn` given): phase
    9's bar of chip_smoke.py, 1e-3 of the tensor's largest plus 1e-5 of
    the model's, and 2e-2 of the tensor's largest for the parameters in
    `before_bn` (BN_SHARE, ROADMAP C6). The JAX step on a (2, 1) mesh is
    itself that far from its single-device step: its gradients move by up
    to 2e-4 of the model's largest, most in the teacher's conv ->
    BatchNorm blocks, whose cancelled sums move when rounding puts a
    LeakyReLU input across its kink."""
    top = {m: max(np.abs(v).max() for k, v in want.items()
                  if k.startswith(m)) for m in ("vae.", "teacher.")}
    floor = {k: 1e-5 * top[k.split(".")[0] + "."] for k in want}
    if before_bn is None:
        return floor
    return {k: (2e-2 if k in before_bn else 1e-3) * np.abs(v).max()
            + floor[k] for k, v in want.items()}


def _zero_in_exact_arithmetic(k, shape):
    """tests/test_torch_train.py's `_rounding_noise_only` by "vae." /
    "teacher." name: entries whose gradient is rounding noise in either
    package (the key third of each qkv bias, ...)."""
    from test_torch_train import _rounding_noise_only
    from lunaris_orion_tpu_torch.config import VAEConfig
    return _rounding_noise_only(k.split(".", 1)[1], shape, _configs()[1]
                                if k.startswith("vae.") else VAEConfig())


def _grads_match(got, want, where, before_bn=None, part=None):
    """Gradients at `_grad_bars` (a gradient not averaged over the ranks,
    or partial on one of them, is off by half of itself); against the
    JAX package (`before_bn` given) the entries zero in exact arithmetic
    are not compared. `want` is whole; `part(name, array)` gives the part
    of it a rank holds (tensor / expert parallelism), which `got` holds,
    and the bars are the whole tensors'. `got` has a gradient for exactly
    the parameters the rank holds: every one without `part`."""
    part = part or (lambda name, a: a)
    assert set(got) == {k for k, v in want.items()
                        if part(k, v) is not None}
    bars = _grad_bars(want, before_bn)
    for k in got:
        keep = (np.ones(want[k].shape, bool) if before_bn is None
                else ~_zero_in_exact_arithmetic(k, want[k].shape))
        keep = part(k, keep)
        np.testing.assert_allclose(got[k][keep], part(k, want[k])[keep],
                                   rtol=1e-3, atol=bars[k],
                                   err_msg=f"{where} {k}")


def _before_bn():
    """The parameters of the teacher's conv -> [LeakyReLU ->] BatchNorm
    blocks, by "teacher." name (chip_smoke.py's `grad_step`)."""
    from torch import nn
    from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
    return {f"teacher.{name}.{p}"
            for name, mod in LunarMoETeacher(_configs()[2]).named_modules()
            if isinstance(mod, nn.Sequential) and len(mod)
            and isinstance(mod[-1], nn.BatchNorm2d)
            for p, _ in mod.named_parameters()}


@pytest.mark.parametrize("tag", [c[0] for c in STEP_CASES])
def test_two_rank_gradients_whole_on_every_rank(runs, tag):
    """After a 2-rank step every parameter's averaged, clipped gradient is
    whole: the replicated parameters' are the same on both ranks, bit for
    bit (the ranks of a model row under CP and TP/EP; the data ranks under
    DP), and every rank's gradients (its own part of a split parameter)
    equal the same part of the port's single-process gradient over the
    global batch at `_grads_match`'s bar: the VAE's, the teacher's, and
    the attention's per-key rel-pos parameters, whose gradient each q
    shard sees only in part under CP. Under a model axis the replicated
    gradients are already the same bits before the step takes the model
    axis's first rank's. Each rank has a gradient for exactly the
    parameters it holds (every one without a split); under TP/EP the two
    ranks' parts cover every parameter."""
    case = next(c for c in STEP_CASES if c[0] == tag)
    want = _named(runs["single"], "single", "grad")
    assert any("rel_pos_h" in k for k in want)
    assert any(k.startswith("vae.") for k in want)
    a, b = (_named(res, tag, "grad") for res in runs["ranks"])
    assert set(a) | set(b) == set(want)
    for k in set(a) & set(b):
        if a[k].shape == b[k].shape == want[k].shape:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for res, got in zip(runs["ranks"], (a, b)):
        _grads_match(got, want, tag, part=_part(res, tag, case[1], case[2]))
    r0, r1 = runs["ranks"]
    assert (f"{tag}/held" in r0) == (tag != "dp")
    if tag != "dp":
        np.testing.assert_array_equal(r0[f"{tag}/held"], r1[f"{tag}/held"])


@pytest.mark.parametrize("tag", [c[0] for c in DROPOUT_CASES])
def test_dp_step_with_dropout_matches_single_process(runs, tag):
    """With dropout 0.1 in every layer (K2's hash in the attention, rows
    numbered by row_offset; globally, and over windows of 64 tokens folded
    into the heads) the DP (2, 1) step draws what the single-process step
    draws for each sample, and so does the TP/EP (1, 2) step, whose ranks
    draw the seeds and head masks of the experts they skip: metrics at
    rtol 1e-4 / atol 1e-6, gradients (a rank's part) at `_grads_match`'s
    bar, the whole parameters at atol 1e-5 / rtol 1e-4."""
    shape = next(c[1] for c in DROPOUT_CASES if c[0] == tag)
    single = runs["single"]
    for r, res in enumerate(runs["ranks"]):
        for kind in ("metric", "param", "buf"):
            got = _named(res, tag, kind)
            want = _named(single, f"single_{tag}", kind)
            assert set(got) == set(want)
            for k, v in want.items():
                tol = (dict(rtol=1e-4, atol=1e-6) if kind == "metric"
                       else dict(rtol=1e-4, atol=1e-5))
                np.testing.assert_allclose(got[k], v, err_msg=f"{r} {k}",
                                           **tol)
        _grads_match(_named(res, tag, "grad"),
                     _named(single, f"single_{tag}", "grad"), f"rank {r}",
                     part=_part(res, tag, shape))


def test_tp_ep_rank_holds_its_part(runs):
    """Under TP/EP (1, 2) with 2 experts and latent 16, model rank m holds
    expert m and its quality head only, and the latent columns [8 m,
    8 m + 8) of the FC pair: fc_mu / fc_logvar [8, bottleneck] and their
    bias [8], decoder.fc [bottleneck, 8] with its whole bias; each AdamW
    moment has its parameter's shape, and exactly those parameters are
    marked split. The Trainer at --mesh_shape 1 2 holds the same, and its
    memory probe runs on its split models and leaves them as they were."""
    cfg, vcfg, tcfg = _configs()
    b = vcfg.bottleneck_dim
    split = {"vae.encoder.fc_mu.weight": (8, b), "vae.encoder.fc_mu.bias": (8,),
             "vae.encoder.fc_logvar.weight": (8, b),
             "vae.encoder.fc_logvar.bias": (8,),
             "vae.decoder.fc.weight": (b, 8)}
    for m, res in enumerate(runs["ranks"]):
        assert list(res["tp_ep/experts"]) == [m]
        assert list(res["tp_ep/heads"]) == [m]
        assert list(res["tp_ep_trainer/experts"]) == [m]
        assert int(res["tp_ep_trainer/fc_mu_rows"]) == 8
        assert bool(res["tp_ep_trainer/probe_kept_state"])
        shapes = _named(res, "tp_ep", "shape")
        for k, (p, mu, nu) in shapes.items():
            assert tuple(p) == tuple(mu) == tuple(nu), k
            assert bool(res[f"tp_ep/split/{k}"]) == (
                k in split or ".experts." in k or ".quality_heads." in k), k
            if k in split:
                assert tuple(p) == split[k], k
            expert = next((int(k.split(".")[2]) for pre in (
                "teacher.experts.", "teacher.quality_heads.")
                if k.startswith(pre)), None)
            assert expert in (None, m), k
        assert tuple(shapes["vae.decoder.fc.bias"][0]) == (b,)


def test_two_rank_trainer_epoch_and_resume(runs):
    """A 2-rank Trainer (--mesh_shape 2 1): each rank's staged batches are
    its slice of the global batch, in the single-process loader's order;
    the metrics of every step are the same on both ranks; the prompt-
    embedding table is whole on each rank and equals the one a rank
    computes alone (atol 1e-6: the rows were embedded in other batch
    shapes); the resume restores the saved step on both ranks, bit for
    bit, and after 4 AdamW steps (bf16 first moments) the two ranks hold
    the same parameters."""
    from lunaris_orion_tpu_torch.data.dataset import (BatchLoader,
                                                      SpriteDataset,
                                                      train_val_split)
    from lunaris_orion_tpu_torch.config import TrainConfig
    seed = TrainConfig().seed
    ds = SpriteDataset(str(runs["path"] / "sprites"), image_size=SIZE)
    tr, _ = train_val_split(len(ds), 0.2, seed)
    r0, r1 = runs["ranks"]
    np.testing.assert_array_equal(r0["trainer/train_indices"], tr)
    loader = BatchLoader(ds, tr, batch_size=4, accum_steps=2, seed=seed,
                         with_indices=True)
    loader.set_epoch(0)
    want = np.stack([idx for _, idx in loader])          # [steps, A, 4]
    got = np.concatenate([r0["trainer/indices"], r1["trainer/indices"]],
                         axis=2)
    np.testing.assert_array_equal(got, want)
    assert r0["trainer/metrics"].shape[0] == 2
    np.testing.assert_array_equal(r0["trainer/metrics"],
                                  r1["trainer/metrics"])
    for res in (r0, r1):
        assert res["trainer/table"].shape == (len(ds), 8)
        np.testing.assert_allclose(res["trainer/table"],
                                   res["trainer/own_table"], atol=1e-6,
                                   rtol=0)
        assert int(res["trainer/resumed_step"]) == 2
        assert bool(res["trainer/resumed_equal"])
        assert int(res["trainer/final_step"]) == 4
    np.testing.assert_array_equal(r0["trainer/final"], r1["trainer/final"])


def test_tp_ep_trainer_checkpoint_is_the_single_process_file(
        runs, monkeypatch):
    """The 2-rank Trainer at --mesh_shape 1 2 (tensor and expert
    parallelism, dropout 0.1: every rank draws the single-process masks)
    writes, after one epoch, the checkpoint a single-process Trainer of
    the same config writes: the same keys, shapes and dtypes; the
    parameters and BatchNorm statistics at atol 1e-5 / rtol 1e-4, AdamW's
    moments at rtol 1e-3 and atol 1e-5 of the model's largest (the moments'
    bar of tests/test_torch_train.py); entries moved by rounding noise
    alone (`_rounding_noise_only`) within two steps' reach, 4 lr; and, as
    `adam_outliers` allows (ROADMAP C6), up to 4 parameter entries of a
    model held to that reach instead. A single process then resumes from
    the file (--mesh_shape 1 1): the whole state, bit for bit, and one
    more epoch."""
    from lunaris_orion_tpu_torch.config import VAEConfig
    from lunaris_orion_tpu_torch.train import loop
    from lunaris_orion_tpu_torch.train.checkpoint import checkpoint_file
    from test_torch_train import _rounding_noise_only
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    path = runs["path"]
    single = loop.Trainer(_tp_ep_trainer_config(path, "single_run"))
    single.train()
    files = [checkpoint_file(str(path / run / "checkpoints"))
             for run in ("tp_ep_run", "single_run")]
    got, want = (torch.load(f, weights_only=False) for f in files)
    assert got.keys() == want.keys()
    assert got["global_step"] == want["global_step"] == 2
    vcfg = _configs()[1]
    for sd in ("vae_state_dict", "teacher_state_dict"):
        outliers = 0
        assert got[sd].keys() == want[sd].keys()
        for k, w in want[sd].items():
            a = got[sd][k]
            assert a.shape == w.shape and a.dtype == w.dtype, k
            if not a.is_floating_point():
                assert torch.equal(a, w), k
                continue
            a, w = a.numpy(), w.numpy()
            # As in tests/test_torch_trainer.py's `epoch_matches_jax`: the
            # experts' first shortcut conv's bias is cancelled by the
            # train-mode BatchNorm after it, whose running mean carries it.
            noise = (_rounding_noise_only(
                k, w.shape, vcfg if sd.startswith("vae") else VAEConfig())
                | k.endswith(("shortcut.0.bias", "shortcut.1.running_mean")))
            off = ~noise & ~np.isclose(a, w, atol=1e-5, rtol=1e-4)
            if "running" not in k:
                outliers += int(off.sum())
                noise = noise | off
            np.testing.assert_allclose(a[~noise], w[~noise], atol=1e-5,
                                       rtol=1e-4, err_msg=f"{sd} {k}")
            np.testing.assert_allclose(a[noise], w[noise], atol=4e-4, rtol=0,
                                       err_msg=f"{sd} {k}")
        assert outliers <= 4, (sd, outliers)
    for opt in ("vae_optimizer", "teacher_optimizer"):
        assert got[opt]["param_groups"] == want[opt]["param_groups"]
        assert got[opt]["state"].keys() == want[opt]["state"].keys()
        for moment in ("exp_avg", "exp_avg_sq"):
            top = max(float(st[moment].abs().max())
                      for st in want[opt]["state"].values())
            for i, st in want[opt]["state"].items():
                np.testing.assert_allclose(
                    got[opt]["state"][i][moment].numpy(), st[moment].numpy(),
                    rtol=1e-3, atol=1e-5 * top, err_msg=f"{opt} {i} {moment}")
    resumed = loop.Trainer(_tp_ep_trainer_config(
        path, "resumed", mesh_shape=(1, 1),
        resume_from=str(path / "tp_ep_run" / "checkpoints")))
    assert resumed.mesh is None and resumed.state.step == 2
    for sd, model in (("vae_state_dict", resumed.state.vae),
                      ("teacher_state_dict", resumed.state.teacher)):
        for k, v in model.state_dict().items():
            assert torch.equal(v, got[sd][k]), k
    for opt, name in ((resumed.state.vae_opt, "vae_optimizer"),
                      (resumed.state.teacher_opt, "teacher_optimizer")):
        for i, p in enumerate(opt.params):
            for moment in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.opt.state[p][moment],
                                   got[name]["state"][i][moment])
    resumed.train()
    assert resumed.state.step == 4
